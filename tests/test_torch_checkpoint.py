"""The port's checkpointing (``repro_torch.ckpt.checkpoint``) and exact
resume through ``launch.train`` on the CPU, at ``smoke_config("llama3_8b")``
with float32 and with int8 moments.

Exact resume is bitwise, with no tolerance (as the reference pins it,
``tests/test_train_infra.py``): every leaf of the state (masters, the
bfloat16 compute copy, moments, the optimizer step) and every loss after
a restore equal the run that never stopped.  Against the reference, the
masters after save, restore and two more steps are held to the 1e-4
norm-relative bound of ``tests/test_torch_train.py`` (the same
arithmetic summed in another order).
"""
import dataclasses
import json
import shutil
import signal
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.ckpt import restore as ref_restore
from repro.ckpt import save as ref_save
from repro.train import steps as ref_steps
from repro_torch.ckpt import AsyncCheckpointer, latest_step, restore, save
from repro_torch.ckpt import checkpoint as ckpt_mod
from repro_torch.configs import ShapeConfig, smoke_config
from repro_torch.data import make_batch_fn, shard_batch
from repro_torch.launch import train as train_launcher
from repro_torch.launch.train import build_state
from repro_torch.models.convert import train_state_from_reference
from repro_torch.optim import AdamWHyper
from repro_torch.train import steps as steps_lib
from torch_lm_parity import configs, reference_tree
from torch_threads import capped_torch_threads  # noqa: F401

MOMENTS = ["float32", "int8"]


def setup(moments="float32", seed=0):
    cfg = dataclasses.replace(smoke_config("llama3_8b"),
                              opt_moment_dtype=moments)
    state = build_state(cfg, seed, "cpu")
    get = make_batch_fn(cfg, ShapeConfig("t", 64, 8, "train"))
    step = steps_lib.make_train_step(cfg, AdamWHyper(
        lr=3e-3, warmup_steps=2, total_steps=60))
    return cfg, state, step, lambda i: shard_batch(get(i), "cpu")


def bits(t: torch.Tensor) -> torch.Tensor:
    t = t.detach()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def assert_states_equal(a, b):
    fa, fb = list(ckpt_mod._flatten(a)), list(ckpt_mod._flatten(b))
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert torch.equal(bits(x), bits(y)), k


def snapshot(state) -> dict:
    return {k: v.detach().clone() for k, v in ckpt_mod._flatten(state)}


@pytest.mark.parametrize("moments", MOMENTS)
def test_checkpoint_exact_resume(tmp_path, moments):
    """5 steps, save, 3 more, against a fresh state restored at 5 and 3
    more: every leaf and every loss bitwise."""
    cfg, state, step, batch = setup(moments)
    for i in range(5):
        state, _ = step(state, batch(i))
    save(tmp_path, 5, state, {"arch": cfg.name})
    cont = []
    for i in range(5, 8):
        state, m = step(state, batch(i))
        cont.append(float(m["loss"]))
    _, fresh, _, _ = setup(moments, seed=1)
    params_c = fresh["params_c"]
    got, at, extra = restore(tmp_path, fresh)
    assert (at, extra) == (5, {"arch": cfg.name}) and got is fresh
    assert got["params_c"] is params_c          # restored in place
    assert all(p.requires_grad for p in params_c.parameters())
    rest = []
    for i in range(5, 8):
        got, m = step(got, batch(i))
        rest.append(float(m["loss"]))
    assert rest == cont
    assert_states_equal(state, got)


def test_checkpoint_detects_corruption(tmp_path):
    _, state, _, _ = setup()
    d = save(tmp_path, 1, state)
    manifest = json.loads((d / "manifest.json").read_text())
    victim = d / manifest["leaves"]["params/final_g"]["file"]
    data = bytearray(victim.read_bytes())
    data[-1] ^= 0xFF
    victim.write_bytes(bytes(data))
    with pytest.raises(IOError, match="params/final_g"):
        restore(tmp_path, state)
    victim.write_bytes(bytes(data[:-4]))          # truncated
    with pytest.raises(IOError):
        restore(tmp_path, state)


def test_async_checkpointer_keeps_two_and_leaves_no_temporaries(tmp_path):
    _, state, _, _ = setup()
    ck = AsyncCheckpointer(tmp_path / "ck", keep=2)
    for s in (1, 2, 3):
        ck.save(s, state)
    ck.close()
    assert latest_step(tmp_path / "ck") == 3
    assert sorted(p.name for p in (tmp_path / "ck").glob("step_*")) == \
        ["step_00000002", "step_00000003"]
    assert not list(tmp_path.rglob("*.tmp-*"))
    _, at, _ = restore(tmp_path / "ck", state)
    assert at == 3
    with pytest.raises(RuntimeError, match="after close"):
        ck.save(4, state)


def test_wait_and_close_return_after_the_write(tmp_path, monkeypatch):
    """A slow writer: ``wait`` returns with the checkpoint on disk (the
    reference's returns while the write is in flight), and so does
    ``close``."""
    _, state, _, _ = setup()
    orig = ckpt_mod.save

    def slow(*a, **k):
        time.sleep(0.3)
        return orig(*a, **k)

    monkeypatch.setattr(ckpt_mod, "save", slow)
    ck = AsyncCheckpointer(tmp_path)
    ck.save(1, state)
    ck.wait()
    assert latest_step(tmp_path) == 1
    ck.save(2, state)
    ck.close()
    assert latest_step(tmp_path) == 2 and not ck._t.is_alive()


def test_snapshot_is_unaffected_by_in_place_updates(tmp_path, monkeypatch):
    """The writer held back until the state has been changed in place
    (as the next train step changes it): the checkpoint holds the state
    as it was at ``save``."""
    _, state, step, batch = setup("int8")
    state, _ = step(state, batch(0))
    before = snapshot(state)
    gate = threading.Event()
    orig = ckpt_mod.save

    def gated(*a, **k):
        assert gate.wait(30)
        return orig(*a, **k)

    monkeypatch.setattr(ckpt_mod, "save", gated)
    ck = AsyncCheckpointer(tmp_path)
    ck.save(1, state)
    with torch.no_grad():
        for _, t in ckpt_mod._flatten(state):
            t.add_(1)
    state, _ = step(state, batch(1))
    gate.set()
    ck.close()
    _, fresh, _, _ = setup("int8", seed=1)
    restore(tmp_path, fresh)
    got = snapshot(fresh)
    assert got.keys() == before.keys()
    for k in before:
        assert torch.equal(bits(got[k]), bits(before[k])), k


def test_bf16_int8_and_the_step_round_trip_bitwise(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"w": torch.tensor(rng.standard_normal((3, 130)),
                              dtype=torch.bfloat16),
            "m": {"q": torch.tensor(rng.integers(-127, 128, (2, 256)),
                                    dtype=torch.int8),
                  "scale": torch.tensor(rng.random((2, 2)),
                                        dtype=torch.float32)},
            "step": torch.tensor(7, dtype=torch.int32)}
    # bfloat16 NaN and infinity payloads survive too
    tree["w"].view(torch.int16)[0, :3] = torch.tensor(
        [0x7FC1, 0x7F80, -0x0080], dtype=torch.int16)
    d = save(tmp_path, 3, tree)
    manifest = json.loads((d / "manifest.json").read_text())
    assert manifest["leaves"]["w"]["dtype"] == "bfloat16"
    assert manifest["leaves"]["step"] == {
        **manifest["leaves"]["step"], "shape": [], "dtype": "int32"}
    like = {"w": torch.zeros(3, 130, dtype=torch.bfloat16),
            "m": {"q": torch.zeros(2, 256, dtype=torch.int8),
                  "scale": torch.zeros(2, 2)},
            "step": torch.zeros((), dtype=torch.int32)}
    got, at, _ = restore(tmp_path, like)
    assert at == 3
    for k in ("w", "step"):
        assert got[k].dtype == tree[k].dtype
        assert torch.equal(bits(got[k]), bits(tree[k]))
    assert torch.equal(got["m"]["q"], tree["m"]["q"])
    assert torch.equal(got["m"]["scale"], tree["m"]["scale"])
    with pytest.raises(ValueError, match="float32"):
        restore(tmp_path, {**like, "w": torch.zeros(3, 130)})
    with pytest.raises(KeyError):
        restore(tmp_path, {**like, "extra": torch.zeros(1)})


def test_writer_error_is_raised_again(tmp_path):
    (tmp_path / "file").write_text("not a directory")
    _, state, _, _ = setup()
    ck = AsyncCheckpointer(tmp_path / "file" / "ck")
    ck.save(1, state)
    with pytest.raises(OSError):
        ck.wait()
    with pytest.raises(OSError):
        ck.save(2, state)
    with pytest.raises(OSError):
        ck.close()
    assert not ck._t.is_alive()


# ---------------------------------------------------------------------------
# the launcher and the example
# ---------------------------------------------------------------------------

TRAIN = ["--arch", "llama3_8b", "--smoke", "--device", "cpu", "--batch",
         "2", "--seq", "32", "--log-every", "100"]


def losses(hist) -> dict:
    return {h["step"]: h["loss"] for h in hist}


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """An 8-step run checkpointing every 2 steps."""
    d = tmp_path_factory.mktemp("ck")
    hist = train_launcher.main(TRAIN + ["--steps", "8", "--ckpt-dir",
                                        str(d), "--ckpt-every", "2"])
    return d, losses(hist)


def test_launch_train_resume_is_bitwise(uninterrupted, capsys):
    """``--resume`` from the 8-step run's step-6 checkpoint: steps 6 and
    7 give that run's losses bitwise.  (A first run of ``--steps 6``
    would not do: the schedule's horizon is ``--steps``, so its state at
    step 6 is another one.)"""
    d, want = uninterrupted
    assert sorted(p.name for p in d.glob("step_*")) == [
        "step_00000004", "step_00000006", "step_00000008"]
    shutil.rmtree(d / "step_00000008")
    hist = train_launcher.main(TRAIN + ["--steps", "8", "--ckpt-dir",
                                        str(d), "--ckpt-every", "2",
                                        "--resume"])
    assert "resumed from step 6" in capsys.readouterr().out
    got = losses(hist)
    assert got == {s: want[s] for s in (6, 7)}


def test_launch_train_preemption_saves_and_resumes(uninterrupted,
                                                   tmp_path, monkeypatch,
                                                   capsys):
    """A preemption signal during step 5 of an 8-step run: the launcher
    checkpoints at step 6 and exits; ``--resume`` trains steps 6 and 7
    to the uninterrupted run's losses, bitwise."""
    _, want = uninterrupted
    make = steps_lib.make_train_step

    def preempted(*a, **k):
        step = make(*a, **k)
        calls = []

        def run(state, batch):
            calls.append(1)
            if len(calls) == 6:
                signal.raise_signal(signal.SIGTERM)
            return step(state, batch)
        return run

    monkeypatch.setattr(steps_lib, "make_train_step", preempted)
    hist = train_launcher.main(TRAIN + ["--steps", "8", "--ckpt-dir",
                                        str(tmp_path), "--ckpt-every", "4"])
    assert "preemption requested" in capsys.readouterr().out
    assert losses(hist) == {s: want[s] for s in range(6)}
    assert latest_step(tmp_path) == 6
    monkeypatch.setattr(steps_lib, "make_train_step", make)
    hist = train_launcher.main(TRAIN + ["--steps", "8", "--ckpt-dir",
                                        str(tmp_path), "--resume"])
    assert losses(hist) == {s: want[s] for s in (6, 7)}


def test_train_example_runs_twice_on_one_directory(tmp_path, capsys):
    """The reference's example fails on its second run (nothing left to
    train, ``losses[-1]`` of an empty list); the port's trains 0 steps
    and says so."""
    from repro_torch.examples import train_lm
    argv = ["--steps", "10", "--device", "cpu", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "5"]
    first = train_lm.main(argv)
    assert len(first) == 10 and latest_step(tmp_path) == 10
    assert train_lm.main(argv) == []
    assert "trained 0 steps" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def rel(got, want) -> float:
    g = np.asarray(got.detach().float(), np.float64)
    w = np.asarray(want, np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


@pytest.mark.parametrize("moments", MOMENTS)
def test_save_restore_train_matches_reference(tmp_path, moments):
    """Both packages from one initial state: 3 steps, save, restore into
    a state of the same structure, 2 more steps; the masters agree to
    1e-4, and each package's restored run is its own uninterrupted run,
    bitwise."""
    cfg, rcfg = configs("llama3_8b", "float32", opt_moment_dtype=moments)
    tree = reference_tree(rcfg)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    wstate = {"params": params,
              "params_c": jax.tree_util.tree_map(lambda x: x, params),
              "opt": ref_optim.init_opt_state(rcfg, params)}
    state = train_state_from_reference(cfg, jax.tree_util.tree_map(
        np.asarray, wstate), "cpu")
    h = ref_optim.AdamWHyper(lr=3e-3, warmup_steps=1, total_steps=10)
    ref_step = jax.jit(ref_steps.make_train_step(rcfg, h))
    step = steps_lib.make_train_step(cfg, AdamWHyper(**dataclasses.asdict(h)))
    get = make_batch_fn(cfg, ShapeConfig("t", 32, 4, "train"))
    for i in range(3):
        b = get(i)
        wstate, _ = ref_step(wstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, _ = step(state, shard_batch(b, "cpu"))
    ref_save(tmp_path / "ref", 3, wstate)
    save(tmp_path / "port", 3, state)
    wrest, _, _ = ref_restore(tmp_path / "ref", wstate)
    fresh = train_state_from_reference(cfg, jax.tree_util.tree_map(
        np.asarray, {"params": params, "opt": ref_optim.init_opt_state(
            rcfg, params)}), "cpu")
    rest, at, _ = restore(tmp_path / "port", fresh)
    assert at == 3
    for i in (3, 4):
        b = get(i)
        wrest, _ = ref_step(wrest, {k: jnp.asarray(v) for k, v in b.items()})
        wstate, _ = ref_step(wstate, {k: jnp.asarray(v) for k, v in b.items()})
        rest, _ = step(rest, shard_batch(b, "cpu"))
        state, _ = step(state, shard_batch(b, "cpu"))
    assert_states_equal(state, rest)
    for name, t in rest["params"].items():
        parts = name.split(".")
        w = wrest["params"][name] if len(parts) == 1 else \
            wrest["params"][parts[0]][parts[2]][int(parts[1])]
        assert rel(t, np.asarray(w)) <= 1e-4, name
        w2 = wstate["params"][name] if len(parts) == 1 else \
            wstate["params"][parts[0]][parts[2]][int(parts[1])]
        assert np.array_equal(np.asarray(w), np.asarray(w2)), name
