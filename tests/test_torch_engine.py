"""PyTorch port: one greedy ``serve_batch``-style wave through the port's
engine gives the JAX ``Engine(impl="ref")``'s tokens, token for token,
with the same preemptions (8 slots, an oversubscribed pool); the sampler's
top-k / top-p masks equal the JAX ones on the same logits; the engine's
unported features raise ``UnsupportedFeature``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke
from repro.serving import Engine as JEngine, Request as JRequest
from repro.serving.sampler import top_k_mask as j_top_k, top_p_mask as j_top_p
from repro_torch.configs import get_smoke as tget_smoke
from repro_torch.errors import InvalidRequest, UnsupportedFeature
from repro_torch.models import params_from_numpy
from repro_torch.serving import Engine, Request, Status
from repro_torch.serving.sampler import SampleParams, sample, top_k_mask, top_p_mask

from _torch_helpers import t


def _prompts(n, max_prompt, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=int(rng.integers(8, max_prompt))
                         ).tolist() for _ in range(n)]


def test_greedy_wave_matches_reference_engine():
    cfg = get_smoke("llama2-7b")
    knobs = dict(max_slots=8, max_seq_len=64, pool_tokens=128)
    prompts = _prompts(10, 40)
    jeng = JEngine(cfg, impl="ref", rng=jax.random.PRNGKey(0), **knobs)
    jreqs = [JRequest(prompt=list(p), max_new_tokens=6) for p in prompts]
    jeng.generate(jreqs)

    params = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                      jeng.params),
                               device="cpu")
    eng = Engine(tget_smoke("llama2-7b"), params, device="cpu",
                 pages_per_block=2, num_splits=2, **knobs)
    reqs = [Request(prompt=list(p), max_new_tokens=6) for p in prompts]
    eng.generate(reqs)

    assert jeng.scheduler.preempted > 0  # the pool was oversubscribed
    assert eng.scheduler.preempted == jeng.scheduler.preempted
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert all(r.status is Status.FINISHED for r in reqs)
    assert eng.steps == jeng.steps
    mem, jmem = eng.memory_report(), jeng.memory_report()
    for key in ("pool_bytes", "reserved_bytes", "used_pages"):
        assert mem[key] == jmem[key]


def test_sampler_masks_match_reference():
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((6, 50)).astype(np.float32) * 3
    logits[1, :10] = logits[1, 0]  # ties at the cutoff
    ks = np.array([0, 5, 1, 50, 3, 12], np.int32)
    ps = np.array([1.0, 0.5, 0.0, 0.9, 0.999, 0.3], np.float32)
    ref_k = np.stack([np.asarray(j_top_k(jnp.asarray(l), k))
                      for l, k in zip(logits, ks)])
    ref_p = np.stack([np.asarray(j_top_p(jnp.asarray(l), p))
                      for l, p in zip(logits, ps)])
    np.testing.assert_array_equal(top_k_mask(t(logits), t(ks)).numpy(),
                                  ref_k)
    np.testing.assert_array_equal(top_p_mask(t(logits), t(ps)).numpy(),
                                  ref_p)
    # greedy rows take argmax; sampled rows stay inside the filtered set
    sp = SampleParams(temperature=t(np.array([0, 1, 0, 1, 0, 1],
                                             np.float32)),
                      top_k=t(ks), top_p=t(ps))
    toks = sample(torch.Generator().manual_seed(0), t(logits), sp).numpy()
    greedy = logits.argmax(-1)
    np.testing.assert_array_equal(toks[::2], greedy[::2])
    kept = np.isfinite(np.stack([np.asarray(j_top_p(jnp.asarray(a), p))
                                 for a, p in zip(ref_k, ps)]))
    assert all(kept[i, toks[i]] for i in (1, 3, 5))


def test_unported_features_raise():
    cfg = tget_smoke("llama2-7b")
    for kw in (dict(prefill_chunk=8), dict(prefix_cache=True),
               dict(faults=object()), dict(paged=False)):
        with pytest.raises(UnsupportedFeature):
            Engine(cfg, device="cpu", **kw)
    eng = Engine(cfg, device="cpu", max_slots=2, max_seq_len=32)
    req = Request(prompt=[1, 2, 3], max_new_tokens=8)
    with pytest.raises(InvalidRequest):
        eng.add_request(Request(prompt=[1], temperature=-1.0))
    eng.add_request(req)
    eng.step()
    with pytest.raises(UnsupportedFeature):
        eng.fork_request(req)
    assert eng.cancel_request(req.rid)
    assert req.status is Status.CANCELLED and eng.mgr.used_pages == 0
