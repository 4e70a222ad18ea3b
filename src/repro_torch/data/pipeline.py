"""Deterministic synthetic data, from the reference's
``repro.data.pipeline``: token batches keyed on (seed, step) through
numpy's ``default_rng``, so the batch of step k is bitwise the
reference's, and a restart at step k regenerates it without a dataset
cursor.  ``shard_batch`` moves a batch to the device (one device: no
sharding)."""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # a Markov chain with noise, so that the loss has structure to learn
    structure: bool = True


class SyntheticLM:
    """tokens[t + 1] = perm[tokens[t]], or a random token with
    probability 0.1: learnable and deterministic."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self._perm = rng.permutation(cfg.vocab)

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """``tokens`` and ``labels`` (B, S) int32; the labels are the
        tokens shifted left, -1 at the last position (no target)."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S = cfg.global_batch, cfg.seq_len
        toks = np.empty((B, S), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab, B)
        if cfg.structure:
            noise = rng.random((B, S)) < 0.1
            rand = rng.integers(0, cfg.vocab, (B, S))
            for t in range(1, S):
                nxt = self._perm[toks[:, t - 1]]
                toks[:, t] = np.where(noise[:, t], rand[:, t], nxt)
        else:
            toks[:] = rng.integers(0, cfg.vocab, (B, S))
        labels = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1)
        labels[:, -1] = -1
        return {"tokens": toks, "labels": labels.astype(np.int32)}

    def iterator(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1


def make_batch_fn(cfg, shape):
    """step -> numpy batch for a model config and a shape (``seq_len``,
    ``global_batch``): ``SyntheticLM``'s tokens and labels, and a VLM's
    ``patches`` or an encoder-decoder's ``frames`` (float32 standard
    normal from ``default_rng((7, step))``), as the reference's."""
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=shape.seq_len,
                                  global_batch=shape.global_batch))

    def get(step: int) -> dict[str, np.ndarray]:
        b = data.batch(step)
        rng = np.random.default_rng((7, step))
        if cfg.family == "vlm":
            b["patches"] = rng.standard_normal(
                (shape.global_batch, cfg.n_patches, cfg.d_model)
            ).astype(np.float32)
        if cfg.family == "encdec":
            b["frames"] = rng.standard_normal(
                (shape.global_batch, cfg.encoder_frames, cfg.d_model)
            ).astype(np.float32)
        return b

    return get


def shard_batch(batch: dict, device="cuda") -> dict:
    """The numpy batch as tensors on ``device`` (the card unless the
    caller asks for ``"cpu"``; the reference's sharded placement is one
    copy on one device)."""
    import torch

    from ..core.codegen import resolve_device
    dev = resolve_device(device)
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
