"""LM data pipelines: synthetic token streams and file-backed text (port
of ``repro.data.dataset``, numpy only).

Both yield {"inputs": (B, S) int32, "targets": (B, S) int32} next-token
batches of numpy arrays, deterministic under a seed and equal to the JAX
package's for the same seed, with the modality-stub extras of the vlm
and encdec families (precomputed image embeddings and audio frames).  The
training loop moves them to the device.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.data.tokenizer import ByteTokenizer


def text_to_ids(path: str, tokenizer: Optional[ByteTokenizer] = None
                ) -> np.ndarray:
    tok = tokenizer or ByteTokenizer()
    with open(path, "r", errors="replace") as f:
        return np.asarray(tok.encode(f.read()), np.int32)


def _extras(cfg, B: int, rng: np.random.Generator) -> Dict:
    out = {}
    if cfg is None:
        return out
    if cfg.family == "vlm":
        out["image_embeds"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_vision), np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (B, cfg.n_audio_frames, cfg.d_model), np.float32)
    return out


def synthetic_batches(batch: int, seq_len: int, vocab: int, seed: int = 0,
                      cfg=None) -> Iterator[Dict]:
    """Markov-ish synthetic stream: learnable structure (not uniform noise),
    so a few hundred steps visibly reduce loss."""
    rng = np.random.default_rng(seed)
    V = min(vocab, 256)
    # sparse bigram transition table: each token has 8 likely successors
    succ = rng.integers(0, V, size=(V, 8))
    while True:
        toks = np.empty((batch, seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, V, size=batch)
        noise = rng.random((batch, seq_len))
        pick = rng.integers(0, 8, size=(batch, seq_len))
        rand = rng.integers(0, V, size=(batch, seq_len))
        for t in range(seq_len):
            nxt = succ[toks[:, t], pick[:, t]]
            toks[:, t + 1] = np.where(noise[:, t] < 0.9, nxt, rand[:, t])
        yield {"inputs": toks[:, :-1], "targets": toks[:, 1:],
               **_extras(cfg, batch, rng)}


def lm_batches(ids: np.ndarray, batch: int, seq_len: int, seed: int = 0,
               cfg=None) -> Iterator[Dict]:
    """Random-crop next-token batches from one long token array."""
    rng = np.random.default_rng(seed)
    n = len(ids) - seq_len - 1
    if n <= 0:
        reps = -(-(seq_len + 2) // max(len(ids), 1))
        ids = np.tile(ids, reps)
        n = len(ids) - seq_len - 1
    while True:
        starts = rng.integers(0, n, size=batch)
        inp = np.stack([ids[s:s + seq_len] for s in starts])
        tgt = np.stack([ids[s + 1:s + seq_len + 1] for s in starts])
        yield {"inputs": inp.astype(np.int32), "targets": tgt.astype(np.int32),
               **_extras(cfg, batch, rng)}
