"""The port's vlm family (llava_next_34b: the dense decoder with patch
embeddings over the first ``n_patches`` positions) against the JAX
reference on the CPU, at the smoke config with B = 2; the helpers and
tolerances are ``torch_lm_parity``'s."""
import numpy as np
import pytest
import torch

import torch_lm_parity as lp
from repro_torch.models import forward_lm, prefill
from torch_threads import capped_torch_threads  # noqa: F401

ARCH = "llava_next_34b"
P, STEPS = 24, 4


@pytest.mark.parametrize("size", ["smoke", "full"])
def test_model_and_cache_shapes_equal_the_reference(size):
    lp.check_shapes(ARCH, size)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_lm_with_patches_matches_the_reference(dtype):
    lp.check_forward(ARCH, dtype, P + 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_with_patches_matches_the_reference(dtype):
    lp.check_prefill(ARCH, dtype, P)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_the_reference(dtype):
    lp.check_decode(ARCH, dtype, P, STEPS)


def test_greedy_tokens_equal_the_reference_loop():
    lp.check_greedy(ARCH)


def test_decode_matches_forward_in_bfloat16():
    lp.check_decode_vs_forward(ARCH, P, steps=2)


def test_patches_replace_the_first_positions():
    """The patches stand in the first n_patches positions: the logits
    there follow the patches, not the tokens, and the rest differ only
    through attention to them."""
    cfg, _, model, _ = lp.both(ARCH, "float32")
    x = lp.inputs(cfg, P)
    toks = torch.from_numpy(x["prompts"])
    patches = torch.from_numpy(x["patches"])
    with_p = forward_lm(cfg, model, toks, patches=patches)[0]
    other = toks.clone()
    other[:, :cfg.n_patches] = (other[:, :cfg.n_patches] + 1) % cfg.vocab
    assert torch.equal(with_p, forward_lm(cfg, model, other,
                                          patches=patches)[0])
    without = forward_lm(cfg, model, toks)[0]
    assert not torch.allclose(with_p[:, 0], without[:, 0])


def test_a_prompt_shorter_than_the_patches_raises():
    """The reference's sequence grows to n_patches there; the port
    refuses it."""
    cfg, _, model, _ = lp.both(ARCH, "float32")
    x = lp.inputs(cfg, cfg.n_patches - 1)
    with pytest.raises(ValueError, match="patches"):
        prefill(cfg, model, torch.from_numpy(x["prompts"]),
                patches=torch.from_numpy(x["patches"]))


def test_serve_arch_cli_on_the_cpu(capsys):
    lp.check_serve_cli(ARCH, capsys)


def test_serve_draws_patches_as_the_reference():
    """Prompts, then patches (B, n_patches, D) float32, from one
    ``default_rng(seed)``, as the reference's ``serve --arch``."""
    cfg = lp.smoke_config(ARCH)
    x = lp.inputs(cfg, P, seed=5)
    rng = np.random.default_rng(5)
    np.testing.assert_array_equal(
        x["prompts"], rng.integers(0, cfg.vocab, (lp.B, P)).astype(np.int32))
    np.testing.assert_array_equal(x["patches"], rng.standard_normal(
        (lp.B, cfg.n_patches, cfg.d_model)).astype(np.float32))
    assert x["frames"] is None
