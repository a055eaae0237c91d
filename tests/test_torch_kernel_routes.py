"""PyTorch port: the routes of K3 and K4 and their C interface.

- (a) ``flex_route`` and ``prefill_route``: bf16 goes to the bf16
  tensor-core kernels ("tc"), f32 to the split-TF32 tensor-core kernels
  ("tf32x3"); K3 takes every input on them, its int8 pools and pages that
  are not a multiple of 8 tokens as variants of either tile ("tc/int8",
  "tf32x3/odd", ...), each counted apart; other pool dtypes raise.
- (b) every ``extern "C"`` function of ``csrc/*.cu`` has a ``SIGNATURES``
  entry with as many parameters, parsed from the sources (a ctypes
  mismatch would otherwise show only on the card).
- (d) K4's mod lowering: the descriptor the wrapper hands the C entry
  (``lower_mods`` then ``_descriptor``), decoded and evaluated here as the
  kernel evaluates it (terms of column ranges and element predicates, or
  of the terms, score steps in order, aux reads clamped), equals the mods
  themselves on every (b, h, q, k) of a small grid; each descriptor family
  has its compiled kind and its launch counter; past the descriptor's
  limits, or for a mod written in Python, the lowering raises.
- (e) the head dims and GQA groups the kernels take, as pure functions of
  (D, G, dtypes, page): every route takes D in {64, 128, 192, 256} and K1
  any G >= 1 (``decode_group_plan`` cuts the group as the C side's
  ``plan``); other head dims raise ``UnsupportedFeature``; each tile's
  shared memory at D = 192 and 256, computed as the C side computes it
  (stages by ``tile_stages``), fits the 232,448 bytes of one block, and so
  does K1's at every G.
- (c) the tensor-core kernels feed P to p.V in bf16: K4 as one bf16
  term, K3 as two (hi + lo).  The plain K4 and K3 versions with that
  rounding stay within the card's bf16 tolerance, ``|a - b| <= 2e-2 *
  (1 + |b|)``, of the unrounded plain versions, at the main paths' shapes
  cut in heads, from numpy inputs with a fixed seed.  K3's partials are
  un-normalised sums over up to ~1500 keys, where one bf16 term leaves
  errors of order 2^-9 * sqrt(sum p^2 v^2): beyond the tolerance, hence
  its two terms.
"""

import re
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import (HEAD_DIMS, SMEM_LIMIT, check_head_dim,
                                 tile_keys, tile_smem_bytes)
from repro_torch.core import flex
from repro_torch.errors import UnsupportedFeature
from repro_torch.kernels import build
from repro_torch.kernels.flex_attention import flex_attention as fa
from repro_torch.kernels.paged_attention import paged_attention as pa

BF16_TOL = 2e-2  # chip_smoke's bf16 tolerance, relative: tol * (1 + |b|)


def rel_err(got, want):
    """max |a - b| / (1 + |b|): within BF16_TOL passes the card's check."""
    got, want = got.float(), want.float()
    assert got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    return float(((got - want).abs() / (1 + want.abs())).max())


# -- (a) the routes ----------------------------------------------------------
@pytest.mark.parametrize("D", [64, 128, 192, 256])
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tc"),
                                         (torch.float32, "tf32x3")])
def test_flex_route_by_dtype(dtype, route, D):
    assert fa.flex_route(dtype) == route


@pytest.mark.parametrize("page", [8, 16, 64, 128, 12, 4, 136, 256])
@pytest.mark.parametrize("D", [64, 128, 192, 256])
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.bfloat16, torch.int8), (torch.float32, torch.int8)])
def test_prefill_route_by_dtype_and_page(q_dtype, kv_dtype, D, page):
    want = "tc" if q_dtype == torch.bfloat16 else "tf32x3"
    if kv_dtype == torch.int8:
        want += "/int8"
    if page % 8:
        want += "/odd"
    assert pa.prefill_route(q_dtype, kv_dtype, page) == want
    # every variant is a route the wrapper counts, and its tile fits
    assert want in pa.ROUTES
    assert tile_smem_bytes(want, D) <= SMEM_LIMIT


@pytest.mark.parametrize("page", [8, 16, 64, 128, 12, 4, 136])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_prefill_int8_pools_and_odd_pages_stay_on_the_cuda_cores(q_dtype,
                                                                 page):
    """Int8 pools and odd pages, which once ran on a CUDA-core kernel, now
    take the tensor-core tile of their q dtype, as variants; every page
    from 1 to 256 tokens does, and pools of another dtype take no tile."""
    tile = "tc" if q_dtype == torch.bfloat16 else "tf32x3"
    for kv_dtype in (q_dtype, torch.int8):
        for p in (page, *range(1, 257)):
            route = pa.prefill_route(q_dtype, kv_dtype, p)
            assert route.split("/")[0] == tile
            assert ("/int8" in route) is (kv_dtype == torch.int8)
            assert route.endswith("/odd") is (p % 8 != 0)
    other = torch.float32 if q_dtype == torch.bfloat16 else torch.bfloat16
    for kv_dtype in (other, torch.float16):
        with pytest.raises(UnsupportedFeature):
            pa.prefill_route(q_dtype, kv_dtype, page)
    with pytest.raises(UnsupportedFeature):
        pa.prefill_route(torch.float16, torch.float16, page)
    with pytest.raises(UnsupportedFeature):
        pa.prefill_route(q_dtype, q_dtype, 0)


def test_route_counts_in_launch_counts_and_reset():
    counts = kernels.launch_counts()
    k3 = ("tc", "tc/odd", "tc/int8", "tc/int8/odd", "tf32x3", "tf32x3/odd",
          "tf32x3/int8", "tf32x3/int8/odd")
    for name, routes in (("flex_prefill", ("tc", "tf32x3")),
                         ("paged_prefill", k3)):
        assert {k for k in counts if k.startswith(name + "/")} == {
            f"{name}/{r}" for r in routes}
    assert set(pa.ROUTES) == set(k3)
    fa.flex_attention_kernel.launches_by_route["tf32x3"] += 3
    pa.paged_prefill_partials.launches_by_route["tc/int8"] += 2
    assert kernels.launch_counts()["flex_prefill/tf32x3"] >= 3
    assert kernels.launch_counts()["paged_prefill/tc/int8"] >= 2
    kernels.reset_launch_counts()
    assert all(n == 0 for n in kernels.launch_counts().values())


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    kernels.reset_launch_counts()
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 16, 64)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    bm = flex.causal_block_mask(16, 16, 16, 16)
    out = fa.flex_attention_kernel(q, k, v, bm, scale=0.125)
    assert out.dtype == torch.bfloat16
    assert all(n == 0 for n in kernels.launch_counts().values())


# -- (b) the C interface -----------------------------------------------------
def c_entry_points():
    """{name: parameter count} of every extern "C" function in csrc/*.cu."""
    found = {}
    for src in sorted(build.CSRC.glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)',
                             text):
            params = [p for p in m.group(2).split(",") if p.strip()]
            found[m.group(1)] = len(params)
    return found


def test_every_entry_point_has_a_signature():
    found = c_entry_points()
    assert set(found) == set(build.SIGNATURES)
    assert {"flex_attention_fwd_tc", "flex_attention_fwd_tf32",
            "paged_prefill_partials_tc",
            "paged_prefill_partials_tf32"} <= set(found)
    # K4's and K3's CUDA-core kernels are gone: every input of either runs
    # on a tensor core
    assert "flex_attention_fwd" not in found
    assert "paged_prefill_partials" not in found
    assert "paged_prefill_kernel<" not in (
        build.CSRC / "paged_prefill.cu").read_text()


@pytest.mark.parametrize("name", sorted(build.SIGNATURES))
def test_signature_matches_the_source(name):
    assert c_entry_points()[name] == len(build.SIGNATURES[name])


# -- (c) P rounded to bf16 ---------------------------------------------------
@pytest.mark.parametrize("Hkv", [4, 2])
def test_flex_plain_with_p_in_bf16_within_tolerance(Hkv):
    """K4's main path (causal & padding, 128 x 128 tiles, D 128) at 4
    heads and Q = K = 384."""
    rng = np.random.default_rng(13)
    B, H, Q, D = 2, 4, 384, 128

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16)

    q, k, v = randn(B, H, Q, D), randn(B, Hkv, Q, D), randn(B, Hkv, Q, D)
    lens = torch.tensor([Q, 201], dtype=torch.int32)
    mm = flex.and_masks(flex.causal_mask, flex.padding_mask(lens))
    bm = flex.build_block_mask(mm, Q, Q, 128, 128, B=B)
    kw = dict(scale=D ** -0.5, mask_mod=mm, q_len=Q, kv_len=Q)
    want = fa._flex_attention_plain(q, k, v, bm, **kw)
    got = fa._flex_attention_plain(q, k, v, bm, p_terms=1, **kw)
    assert not torch.equal(got, want)  # the rounding is really applied
    assert rel_err(got, want) <= BF16_TOL


@pytest.mark.parametrize("splits", [1, 2])
def test_prefill_plain_with_p_in_two_bf16_terms_within_tolerance(splits):
    """K3's main chunk step (resumes at 0 and deep into the prompt, up to
    ~1500 keys, a dead row; D 128, 2 pages per block, q_block 128) at 4
    heads, 128-token chunks and 16-token pages."""
    rng = np.random.default_rng(7)
    H, D, P, max_pages = 4, 128, 16, 96
    q_start = [0, 700, 1400, 1]
    q_lens = [128, 128, 128, 0]
    kv_lens = [s + n for s, n in zip(q_start, q_lens)]
    B, C = len(q_start), max(q_lens)
    num_pages = B * max_pages + 3
    q = torch.from_numpy(rng.standard_normal((B, C, H, D)).astype(
        np.float32)).to(torch.bfloat16)
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (num_pages, P, H, D)).astype(np.float32)).to(torch.bfloat16)
        for _ in range(2))
    perm = rng.permutation(num_pages)
    tables = np.full((B, max_pages), -1, np.int32)
    used = 0
    for b in range(B):
        n = -(-kv_lens[b] // P) if q_lens[b] else 0
        tables[b, :n] = perm[used:used + n]
        used += n
    args = (q, kp, vp, torch.from_numpy(tables),
            torch.tensor(kv_lens, dtype=torch.int32),
            torch.tensor(q_start, dtype=torch.int32))
    kw = dict(scale=D ** -0.5, softcap=0.0, kv_scale=0.0, pages_per_block=2,
              num_splits=splits, q_block=128)
    want = pa._paged_prefill_partials_plain(*args, **kw)
    errs = {}
    for terms in (1, 2):
        got = pa._paged_prefill_partials_plain(*args, p_terms=terms, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert not torch.equal(got[2], want[2])
        errs[terms] = rel_err(got[2], want[2])
    assert errs[2] <= BF16_TOL
    # one term is what the two are for: ~2^8 times the error of two
    assert errs[1] > 100 * errs[2], errs


# -- (d) K4's mod lowering ---------------------------------------------------
def run_descriptor(kind, words, keep, B, H, Q, K, scores):
    """The mask (B, H, Q, K) and the transformed ``scores`` (B, H, Q, K) as
    csrc/flex_prefill.cu evaluates the descriptor's int64 words (FlexTile:
    bounds, live, score; fill_desc's layout), reading aux tensors through
    their addresses in ``keep``."""
    mem = {x.data_ptr(): x.reshape(-1).numpy() for x in keep}
    nt, npd, ns = words[:3]
    x = 3
    terms, preds, steps = [], [], []
    for _ in range(nt):
        terms.append(words[x:x + 4])
        x += 4
    for _ in range(npd):
        preds.append(words[x:x + 7])
        x += 7
    for _ in range(ns):
        steps.append(words[x:x + 3])
        x += 3
    assert x == len(words)
    element = nt != 1 or terms[0][3] != 0
    assert kind == (fa.KIND_ELEMENT if element else 0) | (
        fa.KIND_SCORE if ns else 0)
    b = np.arange(B)[:, None, None, None]
    h = np.arange(H)[None, :, None, None]
    q = np.arange(Q)[None, None, :, None]
    k = np.arange(K)[None, None, None, :]

    def clamp(i, n):
        return np.clip(i, 0, n - 1)

    def pred(d):
        kd, a, pb, pc, na, nb, nc = d
        if kd == fa.PRED_DOCUMENT:
            docs = mem[a].reshape(nb, na)
            row = clamp(b, nb)
            return docs[row, clamp(q, na)] == docs[row, clamp(k, na)]
        sq = mem[a][clamp(q, na)]
        return ((sq == mem[a][clamp(k, na)])
                & (mem[pb][clamp(k, nb)] < mem[pc][clamp(sq, nc)]))

    live = np.zeros((B, H, Q, K), bool)
    for window, prefix, plen, bits in terms:
        m = k < np.maximum(q + 1, prefix)
        if window > 0:
            m = m & (k >= q + 1 - window)
        if plen:
            m = m & (k < mem[plen][b])
        for d in range(npd):
            if (bits >> d) & 1:
                m = m & pred(preds[d])
        live |= np.broadcast_to(m, live.shape)
    s = scores.copy()
    for kd, value, n in steps:
        if kd == fa.STEP_SOFTCAP:
            cap = struct.unpack("<f", struct.pack("<i", value))[0]
            s = cap * np.tanh(s / cap)
        else:
            s = s - mem[value][clamp(h, n)] * (q - k)
    return live, s


LOWER_CASES = {  # name: (mask, score, kind, variant name)
    "causal&padding": (lambda L: flex.and_masks(
        flex.causal_mask, flex.padding_mask(L["lens"])), None, 0,
        "causal&padding"),
    "window&padding": (lambda L: flex.and_masks(
        flex.sliding_window_mask(5), flex.padding_mask(L["lens"])), None, 0,
        "window&padding"),
    "full": (lambda L: flex.full_mask, None, 0, "full"),
    "prefix_lm": (lambda L: flex.prefix_lm_mask(7), None, 0, "prefix_lm"),
    "two paddings": (lambda L: flex.and_masks(
        flex.padding_mask(L["lens"]), flex.causal_mask,
        flex.padding_mask(L["lens2"])), None, 0, "causal&padding"),
    "window0": (lambda L: flex.sliding_window_mask(0), None,
                fa.KIND_ELEMENT, "none"),
    "document": (lambda L: flex.and_masks(
        flex.causal_mask, flex.document_mask(L["docs"])), None,
        fa.KIND_ELEMENT, "causal&document"),
    "paged": (lambda L: flex.paged_mask(L["sid"], L["pos"], L["slens"]),
              None, fa.KIND_ELEMENT, "paged"),
    "or": (lambda L: flex.or_masks(flex.prefix_lm_mask(6),
                                   flex.sliding_window_mask(3)), None,
           fa.KIND_ELEMENT, "prefix_lm|window"),
    "and of ors": (lambda L: flex.and_masks(
        flex.or_masks(flex.causal_mask, flex.document_mask(L["docs"])),
        flex.or_masks(flex.padding_mask(L["lens"]),
                      flex.sliding_window_mask(4))), None, fa.KIND_ELEMENT,
        "causal&padding|window|padding&document|window&document"),
    "softcap": (lambda L: flex.causal_mask, lambda L: flex.softcap_score(
        2.0), fa.KIND_SCORE, "causal+softcap"),
    "compose": (lambda L: flex.and_masks(
        flex.sliding_window_mask(5), flex.padding_mask(L["lens"])),
        lambda L: flex.compose_score(flex.alibi_score(L["slopes"]),
                                     flex.identity_score,
                                     flex.softcap_score(3.0)),
        fa.KIND_SCORE, "window&padding+alibi+softcap"),
    "document+alibi": (lambda L: flex.document_mask(L["docs"]),
                       lambda L: flex.alibi_score(L["slopes"]),
                       fa.KIND_ELEMENT | fa.KIND_SCORE,
                       "document+alibi"),
}


@pytest.mark.parametrize("name", sorted(LOWER_CASES))
def test_mod_lowering_evaluates_as_the_mods(name):
    B, H, Q = 2, 3, 19
    rng = np.random.default_rng(4)
    aux = {"lens": torch.tensor([Q, 11], dtype=torch.int32),
           "lens2": torch.tensor([9, 15], dtype=torch.int64),
           "docs": torch.from_numpy(rng.integers(0, 3, (B, Q))),
           "sid": torch.tensor([0] * 7 + [1] * 5 + [2] * 7),
           "pos": torch.tensor(list(range(7)) + list(range(5))
                               + list(range(7))),
           "slens": torch.tensor([4, 5, 7]),
           "slopes": torch.tensor([0.5, 0.25, 0.125])}
    make_mask, make_score, kind, vname = LOWER_CASES[name]
    mask = make_mask(aux)
    score = make_score(aux) if make_score else None
    low = fa.lower_mods(mask, score)
    assert (low.kind, low.name) == (kind, vname)
    words, keep = fa._descriptor(low, B, torch.device("cpu"))
    scores = (rng.standard_normal((B, H, Q, Q)) * 4).astype(np.float32)
    live, got = run_descriptor(low.kind, list(words), keep, B, H, Q, Q,
                               scores)
    want = np.broadcast_to(flex.materialize(mask, B, H, Q, Q).numpy(),
                           live.shape)
    np.testing.assert_array_equal(live, want)
    if score is not None:
        idx = [torch.arange(n).reshape(shape) for n, shape in (
            (B, (B, 1, 1, 1)), (H, (1, H, 1, 1)), (Q, (1, 1, Q, 1)),
            (Q, (1, 1, 1, Q)))]
        np.testing.assert_allclose(
            got, score(torch.from_numpy(scores), *idx).numpy(), rtol=1e-6,
            atol=1e-5)


def test_mod_lowering_limits_and_python_mods_raise():
    terms = [flex.sliding_window_mask(w) for w in range(1, 11)]
    with pytest.raises(UnsupportedFeature):
        fa.lower_mods(flex.or_masks(*terms))  # 10 or-terms > 8
    docs = [flex.document_mask(torch.zeros((1, 4), dtype=torch.int32))
            for _ in range(5)]
    with pytest.raises(UnsupportedFeature):
        fa.lower_mods(flex.and_masks(*docs))  # 5 predicates > 4
    caps = [flex.softcap_score(float(c)) for c in range(1, 6)]
    with pytest.raises(UnsupportedFeature):
        fa.lower_mods(flex.causal_mask, flex.compose_score(*caps))
    with pytest.raises(UnsupportedFeature):
        fa.lower_mods(lambda b, h, q, k: k <= q)
    with pytest.raises(UnsupportedFeature):
        fa.lower_mods(flex.causal_mask, lambda s, b, h, q, k: s)
    # the same predicate twice in a nest is one predicate of the descriptor
    doc = flex.document_mask(torch.zeros((1, 4), dtype=torch.int32))
    low = fa.lower_mods(flex.and_masks(flex.or_masks(doc, flex.causal_mask),
                                       flex.or_masks(doc, flex.full_mask)))
    assert len(low.terms) == 4 and len(low.preds) == 1


def test_variant_counts_in_launch_counts_and_reset():
    kernels.reset_launch_counts()
    variants = fa.flex_attention_kernel.launches_by_variant
    variants["tc/window&padding"] = 3
    assert kernels.launch_counts()["flex_prefill/tc/window&padding"] == 3
    kernels.reset_launch_counts()
    assert "flex_prefill/tc/window&padding" not in kernels.launch_counts()
    assert all(n == 0 for n in kernels.launch_counts().values())


# -- (e) head dims, GQA groups and shared memory ------------------------------
CSRC = Path(build.CSRC)


@pytest.mark.parametrize("D", [64, 128, 192, 256])
@pytest.mark.parametrize("G", [1, 2, 3, 6, 8, 12, 16, 24, 48])
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16,
                                      torch.int8])
def test_every_route_takes_the_head_dims_and_k1_any_group(kv_dtype, G, D):
    for kernel in ("decode kernel", "prefill kernel", "flex kernel"):
        check_head_dim(kernel, D)
    for page in (1, 7, 16, 64, 96):
        assert pa.decode_supported(kv_dtype, D, G, page)


@pytest.mark.parametrize("D", [320, 32, 96, 160])
def test_other_head_dims_raise_naming_the_slice(D):
    for kernel in ("decode kernel", "prefill kernel", "flex kernel"):
        with pytest.raises(UnsupportedFeature) as err:
            check_head_dim(kernel, D)
        # every head dim the reference's configs use is taken: the
        # message names the ones that are, and no slice to come
        assert str(HEAD_DIMS) in str(err.value)
        assert "slice" not in str(err.value)
    assert not pa.decode_supported(torch.bfloat16, D, 1, 64)
    # the decode wrapper's input checks refuse it too
    q = torch.zeros((1, 1, 1, D))
    pools = torch.zeros((2, 16, 1, D))
    with pytest.raises(UnsupportedFeature):
        pa._check_decode_inputs(q, pools, pools,
                                torch.zeros((1, 2), dtype=torch.int32),
                                torch.ones((1,), dtype=torch.int32), 0.0)


@pytest.mark.parametrize("G", list(range(1, 65)))
def test_decode_group_plan_covers_the_group(G):
    gw, slices, chunks, gc = pa.decode_group_plan(G)
    assert gw in pa.DECODE_GROUP_WIDTHS and slices in (1, 2)
    assert gc <= 16 and chunks * gc >= G and (chunks - 1) * gc < G
    assert gw * slices >= gc > gw * (slices - 1) or gw == 1
    assert (chunks == 1) is (G <= 16)  # one pass over K/V up to 16 heads
    assert (slices == 2) is (gc > 4)


def test_decode_group_plan_at_the_configs_groups():
    # llama2-7b, nemotron-4-15b, nemotron-4-340b, llama3-405b, and a group
    # of 48 heads over one kv head (re-read: three chunks)
    assert pa.decode_group_plan(1) == (1, 1, 1, 1)
    assert pa.decode_group_plan(6) == (4, 2, 1, 6)
    assert pa.decode_group_plan(12) == (8, 2, 1, 12)
    assert pa.decode_group_plan(16) == (8, 2, 1, 16)
    assert pa.decode_group_plan(48) == (8, 2, 3, 16)
    with pytest.raises(UnsupportedFeature):
        pa.decode_group_plan(0)


def test_decode_plan_and_tiles_stay_in_step_with_the_c_side():
    decode = (CSRC / "paged_decode.cu").read_text()
    assert "constexpr int kMaxCtaGroup = 16;" in decode
    widths = sorted(int(x) for x in re.findall(
        r"case (\d+): return launch<TKV, D, \d+>", decode))
    assert tuple(widths) == pa.DECODE_GROUP_WIDTHS
    for src, route in (("flash_tc.cuh", "tc"), ("flash_tf32.cuh", "tf32x3")):
        m = re.search(r"kBN = D <= 128 \? (\d+) : (\d+);",
                      (CSRC / src).read_text())
        assert (int(m.group(1)), int(m.group(2))) == (
            tile_keys(route, 128), tile_keys(route, 192))
        assert tile_keys(route, 256) == tile_keys(route, 192)
    assert "return D == 64 || D == 128 || D == 192 || D == 256;" in (
        CSRC / "flash_tc.cuh").read_text()
    # the stages tile_smem_bytes counts: on the bf16 tile three, two at D =
    # 256 but three of int8; on the split-TF32 tile two, three of int8
    # beside its working tiles, and at D = 256 one (two of int8)
    assert "kStages = D <= 192 || I8 ? 3 : 2;" in (
        CSRC / "flash_tc.cuh").read_text()
    assert "kStages = D <= 192 ? (I8 ? 3 : 2) : (I8 ? 2 : 1);" in (
        CSRC / "flash_tf32.cuh").read_text()
    assert [kernels.tile_stages(r, D) for D in (192, 256) for r in (
        "tc", "tc/int8", "tf32x3", "tf32x3/int8")] == [3, 3, 2, 3,
                                                       2, 3, 1, 2]
    assert HEAD_DIMS == (64, 128, 192, 256)
    # every entry point dispatches every head dim
    for src, pattern in (
            ("paged_decode.cu", r"case (\d+): bad = dispatch_kv"),
            ("flex_prefill.cu", r"case (\d+): bad = dispatch_kind"),
            ("paged_prefill.cu", r"case (\d+): return launch_tc<")):
        cases = sorted(int(x) for x in re.findall(
            pattern, (CSRC / src).read_text()))
        assert cases == sorted(
            2 * D if src == "paged_prefill.cu" else D for D in HEAD_DIMS)


@pytest.mark.parametrize("D", [64, 128, 192])
def test_tile_shared_memory_fits_one_block(D):
    for route in pa.ROUTES:
        assert tile_smem_bytes(route, D) <= SMEM_LIMIT
    # the int8 layouts: a ring of int8 stages beside one working stage
    # takes less than the tile's own ring
    for tile in ("tc", "tf32x3"):
        assert tile_smem_bytes(tile + "/int8", D) < tile_smem_bytes(tile, D)
        assert tile_smem_bytes(tile + "/int8/odd", D) == tile_smem_bytes(
            tile + "/int8", D)
    for kv_dtype in (torch.float32, torch.bfloat16, torch.int8):
        for G in range(1, 49):
            assert pa.decode_smem_bytes(kv_dtype, D, G) <= SMEM_LIMIT


def test_tiles_at_d192_take_shorter_stages():
    # the bytes of the C layouts: Q 48 KB + 3 x (24 + 24) KB on the bf16
    # tile; Q hi + Q lo 96 KB + K lo 24 KB + 2 x (24 + 24) KB on the
    # split-TF32 tile (each + 1024 bytes of slack and the barriers)
    assert tile_smem_bytes("tc", 192) == 1024 + 196608 + 48
    assert tile_smem_bytes("tf32x3", 192) == 1024 + 221184 + 32
    assert (tile_keys("tc", 192), tile_keys("tf32x3", 192)) == (64, 32)
    # the D = 128 stages would not fit at D = 192: 7 x 48 KB
    assert 1024 + 7 * 128 * 192 * 2 > SMEM_LIMIT
    assert 1024 + 7 * 64 * 192 * 4 > SMEM_LIMIT
    assert tile_smem_bytes("tc", 128) == 1024 + 229376 + 48
    # int8 pools, as Layout<D, true> lays them out: Q, three stages of
    # int8 K and V, one working K and V stage of the tile's element type
    assert tile_smem_bytes("tc/int8", 128) == (
        1024 + 32768 + 3 * 2 * 16384 + 2 * 32768 + 48)  # 192 KB + slack
    assert tile_smem_bytes("tc/int8", 192) == (
        1024 + 49152 + 3 * 2 * 12288 + 2 * 24576 + 48)  # 168 KB
    assert tile_smem_bytes("tf32x3/int8", 128) == (
        1024 + 2 * 32768 + 3 * 2 * 8192 + 2 * 32768 + 48)  # 176 KB
    assert tile_smem_bytes("tf32x3/int8", 192) == (
        1024 + 2 * 49152 + 3 * 2 * 6144 + 2 * 24576 + 48)  # 180 KB


def test_tiles_at_d256_fit_one_block():
    """recurrentgemma-9b's head dim: every route of both tiles and K1 at
    every group fit one block.  The bytes of the C layouts: Q 64 KB + 2 x
    (32 + 32) KB on the bf16 tile, Q 64 KB + 3 x (16 + 16) KB of int8 + a
    working stage of 2 x 32 KB on int8 pools; Q hi + Q lo 128 KB + K lo 32
    KB + ONE stage of (32 + 32) KB on the split-TF32 tile, Q 128 KB + 2 x
    (8 + 8) KB of int8 + 2 x 32 KB on int8 pools (each + 1024 bytes of
    slack and the barriers)."""
    for route in pa.ROUTES:
        assert tile_smem_bytes(route, 256) <= SMEM_LIMIT
    assert tile_smem_bytes("tc", 256) == 1024 + 196608 + 32
    assert tile_smem_bytes("tc/int8", 256) == (
        1024 + 65536 + 3 * 2 * 16384 + 2 * 32768 + 48)
    assert tile_smem_bytes("tf32x3", 256) == 1024 + 229376 + 16
    assert tile_smem_bytes("tf32x3/int8", 256) == (
        1024 + 2 * 65536 + 2 * 2 * 8192 + 2 * 32768 + 32)
    # a second split-TF32 stage, or a third bf16 one, would not fit
    assert 1024 + 229376 + 65536 > SMEM_LIMIT
    assert 1024 + 65536 + 3 * 65536 > SMEM_LIMIT
    for kv_dtype in (torch.float32, torch.bfloat16, torch.int8):
        for G in range(1, 49):
            assert pa.decode_smem_bytes(kv_dtype, 256, G) <= SMEM_LIMIT
    # recurrentgemma-9b's group: 16 heads over one kv head, two slices of 8
    assert pa.decode_group_plan(16) == (8, 2, 1, 16)
