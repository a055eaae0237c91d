"""Rank processes for the port's distributed tests (tests/test_torch_dist*,
tests/test_torch_ring_ep.py, tests/test_torch_expert_grad.py, ...).

``run_ranks`` starts ``world`` processes (``multiprocessing`` "spawn"
context) that join one ``gloo`` group through a ``FileStore`` in a
temporary directory (no TCP port), build a mesh of ``mesh_shape`` and
run ``fn(mesh, inputs)`` — a function of this module, which imports no
JAX — with one torch thread each.  Each rank's result, a dict of numpy
arrays, comes back through a file; a rank that raises or dies fails the
call with its traceback.  One call runs every case of a test file, so
the files pay the processes' start once.
"""

import os
import pickle
import sys
import traceback

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def _rank_main(rank, world, tmp, mesh_shape, fn_name, in_path):
    out = os.path.join(tmp, f"rank{rank}.pkl")
    try:
        sys.path.insert(0, SRC)
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        store = dist.FileStore(os.path.join(tmp, "store"), world)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world)
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh(mesh_shape)
        with open(in_path, "rb") as f:
            inputs = pickle.load(f)
        res = globals()[fn_name](mesh, inputs)
        dist.barrier()
        dist.destroy_process_group()
        with open(out, "wb") as f:
            pickle.dump({"ok": res}, f)
    except BaseException:  # noqa: BLE001 — reported to the parent
        with open(out, "wb") as f:
            pickle.dump({"error": traceback.format_exc()}, f)
        raise


def run_ranks(tmp, fn_name, inputs, mesh_shape, timeout=240):
    """Run ``fn_name(mesh, inputs)`` on ``prod(mesh_shape)`` gloo ranks;
    returns the list of the ranks' results (rank order)."""
    import multiprocessing as mp
    world = int(np.prod(mesh_shape))
    tmp = str(tmp)
    in_path = os.path.join(tmp, "inputs.pkl")
    with open(in_path, "wb") as f:
        pickle.dump(inputs, f)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(
        r, world, tmp, tuple(mesh_shape), fn_name, in_path))
        for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    for p in procs:
        if p.is_alive():
            p.kill()
    out, errors = [], []
    for r in range(world):
        path = os.path.join(tmp, f"rank{r}.pkl")
        if not os.path.exists(path):
            errors.append(f"rank {r}: no result (exit {procs[r].exitcode})")
            continue
        with open(path, "rb") as f:
            got = pickle.load(f)
        if "error" in got:
            errors.append(f"rank {r}:\n{got['error']}")
        else:
            out.append(got["ok"])
    if errors:
        raise AssertionError("\n".join(errors))
    return out


def _np(x):
    return x.detach().cpu().float().numpy()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


# ---------------------------------------------------------------------------
# rank bodies
# ---------------------------------------------------------------------------
def kvp_cases(mesh, inputs):
    """kvp decode attention over this rank's stripe of each case's pools:
    the rank keeps logical pages j·n + s of each row (local pool of its
    pages in row-major order), runs ``decode_attention_sharded`` with
    both merges, through K1's plain version (``impl="kernel"``) and the
    plain partials (``impl="ref"``)."""
    import torch
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.sharding import DEFAULT_RULES, use_mesh
    out = {}
    batch_axes = tuple(inputs["batch_axes"])
    for name, c in inputs["cases"].items():
        q4, kp, vp, lens = (torch.from_numpy(c[k]) for k in
                            ("q4", "kp", "vp", "lens"))
        B, pps = c["logical"].shape
        with use_mesh(mesh, DEFAULT_RULES.extend(batch=batch_axes or None)):
            kv_axes = coll.kv_axes_of(mesh, batch_axes)
            n, s = mesh.prod(kv_axes), mesh.flat_index(kv_axes)
            nb = mesh.prod(batch_axes) if batch_axes else 1
            bi = mesh.flat_index(batch_axes) if batch_axes else 0
            rows = range(bi * B // nb, (bi + 1) * B // nb)
            pages, tables = [], []
            for b in rows:
                cols = list(range(s, pps, n))
                tables.append([len(pages) + i for i in range(len(cols))])
                pages += [int(c["logical"][b, j]) for j in cols]
            idx = torch.tensor(pages, dtype=torch.long)
            t = torch.tensor(tables, dtype=torch.int32)[:, None, :]
            r = list(rows)
            for impl in ("kernel", "ref"):
                for mode in ("kernel", "plain"):
                    o = coll.decode_attention_sharded(
                        q4[r], kp[idx].contiguous(), vp[idx].contiguous(),
                        t, lens[r], scheme="kvp", batch_axes=batch_axes,
                        impl=impl, combine_mode=mode)
                    out[f"{name}/{impl}/{mode}"] = _np(o)
            out[f"{name}/rows"] = np.asarray(r)
    return out


def tp_dp_cases(mesh, inputs):
    """tp and dp decode attention and the writes of every scheme on this
    rank's part of each case (heads under tp, q-head groups under dp —
    every head when the mesh does not divide G —, page stripes under kvp
    for the decode write)."""
    out = {}
    for name, c in inputs["cases"].items():
        for k, v in _tp_dp_case(mesh, c).items():
            out[f"{name}/{k}"] = v
    return out


def _tp_dp_case(mesh, c):
    import torch
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.sharding import use_mesh
    out = {}
    m = mesh.size("model")
    r = mesh.index("model")
    c = {k: torch.from_numpy(v) for k, v in c.items()}
    q4, kp, vp, t, lens = c["q4"], c["kp"], c["vp"], c["tables"], c["lens"]
    B, Hkv, G, D = q4.shape
    with use_mesh(mesh):
        w = Hkv // m
        h = slice(r * w, (r + 1) * w)
        o = coll.decode_attention_sharded(
            q4[:, h].contiguous(), kp[:, :, h].contiguous(),
            vp[:, :, h].contiguous(), t[:, None], lens, scheme="tp")
        out["tp"] = _np(o)
        g = G // m if G % m == 0 else G
        gs = slice(r * g, (r + 1) * g) if G % m == 0 else slice(0, G)
        o = coll.decode_attention_sharded(
            q4[:, :, gs].contiguous(), kp, vp, t[:, None], lens, scheme="dp")
        out["dp"] = _np(o)
        pos, kn, vn = c["pos"], c["k_new"], c["v_new"]
        for scheme in ("tp", "dp"):
            heads = h if scheme == "tp" else slice(0, Hkv)
            kl = kp[:, :, heads].clone()
            vl = vp[:, :, heads].clone()
            coll.write_decode_sharded(kl, vl, t[:, None], pos,
                                      kn[:, heads].contiguous(),
                                      vn[:, heads].contiguous(),
                                      scheme=scheme)
            out[f"write_decode/{scheme}"] = np.stack([_np(kl), _np(vl)])
        # kvp: the rank's stripe of every row, local ids row-major
        pps = t.shape[1]
        pages, tables = [], []
        for b in range(B):
            cols = list(range(r, pps, m))
            tables.append([len(pages) + i for i in range(len(cols))])
            pages += [int(t[b, j]) for j in cols]
        idx = torch.tensor(pages, dtype=torch.long)
        kl, vl = kp[idx].contiguous(), vp[idx].contiguous()
        coll.write_decode_sharded(
            kl, vl, torch.tensor(tables, dtype=torch.int32)[:, None], pos,
            kn, vn, scheme="kvp", batch_axes=())
        out["write_decode/kvp"] = np.stack([_np(kl), _np(vl)])
        out["kvp_pages"] = idx.numpy()
        k, v, plens = c["k"], c["v"], c["plens"]
        for scheme in ("tp", "dp", "kvp"):
            heads = h if scheme == "tp" else slice(0, Hkv)
            kl = torch.zeros_like(kp[:, :, heads]).contiguous()
            vl = torch.zeros_like(kl)
            coll.write_prefill_sharded(kl, vl, t[:, None],
                                       k[:, :, heads], v[:, :, heads], plens)
            out[f"write_prefill/{scheme}"] = np.stack([_np(kl), _np(vl)])
    return out


def model_cases(mesh, inputs):
    """Each case's smoke model served under its plan on this mesh: the
    JAX weights cut to the rank (``sharded_params_from_numpy``), prefill
    under the plan (tp: into pools of the rank's kv heads; dp and kvp:
    every head), ``shard_decode_state`` to the decode layout, then
    ``steps`` greedy tokens through ``build_serve_step``.  Returns the
    prefill logits, every step's logits and the tokens."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.distributed.collectives import shard_decode_state
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch.steps import build_serve_step, plan_for
    from repro_torch.models.convert import sharded_params_from_numpy
    out = {}
    for name, c in inputs["cases"].items():
        cfg = get_config(c["config"]).smoke().replace(**c["replace"])
        tokens = torch.from_numpy(c["tokens"])
        lens = torch.from_numpy(c["lens"])
        B, S = tokens.shape
        run = RunConfig(model=cfg, seq_len=S + c["steps"], global_batch=B,
                        kind="decode")
        plan = plan_for(run, mesh, scheme=c["scheme"])
        step, _, _, model = build_serve_step(run, plan)
        params = sharded_params_from_numpy(c["params"], model, plan,
                                           device="cpu")
        state = model.init_decode_state(run, device="cpu", plan=plan)
        pps = state["tables"].shape[2]
        state["tables"] = torch.arange(B * pps, dtype=torch.int32).reshape(
            B, 1, pps)
        with use_mesh(plan.mesh, plan.rules):
            logits, state = model.prefill(params, tokens, state, lens,
                                          attn_ctx=plan.attn_ctx)
        out[f"{name}/prefill"] = _np(logits)
        state = shard_decode_state(state, plan)
        tok = logits.argmax(-1).to(torch.int32)
        steps, toks = [], [tok]
        for _ in range(c["steps"]):
            logits, state = step(params, tok, state)
            steps.append(_np(logits))
            tok = logits.argmax(-1).to(torch.int32)
            toks.append(tok)
        out[f"{name}/steps"] = np.stack(steps)
        out[f"{name}/tokens"] = torch.stack(toks).numpy()
        out[f"{name}/scheme"] = plan.scheme
        out[f"{name}/pool_heads"] = state["k_pages"].shape[3]
        # drawing under the plan = drawing whole, then cutting
        gen = torch.Generator().manual_seed(7)
        drawn = model.init_params(gen, plan=plan)
        gen = torch.Generator().manual_seed(7)
        cut = model.shard_params(model.init_params(gen), plan)
        out[f"{name}/init_equal"] = all(
            torch.equal(a, b) for a, b in zip(_leaves(drawn), _leaves(cut)))
        out[f"{name}/init_shapes"] = [tuple(a.shape) for a in _leaves(drawn)]
    return out


def ring_cases(mesh, inputs):
    """``prefill_attention(impl="ring")`` on this rank's sequence slice
    (slice r of "model") of its batch rows (over "data" when the mesh has
    more than one data rank)."""
    import torch
    from repro_torch.core.attention import prefill_attention
    from repro_torch.distributed.sharding import DEFAULT_RULES, use_mesh
    out = {}
    nd, m = mesh.size("data"), mesh.size("model")
    d, r = mesh.index("data"), mesh.index("model")
    ba = ("data",) if nd > 1 else None
    rules = DEFAULT_RULES.extend(batch=ba, seq=("model",))
    for name, c in inputs["cases"].items():
        q, k, v = (torch.from_numpy(c[x]) for x in ("q", "k", "v"))
        B, S = q.shape[:2]
        rows = slice(d * B // nd, (d + 1) * B // nd)
        sl = slice(r * S // m, (r + 1) * S // m)
        lens = None if c["lens"] is None else torch.from_numpy(c["lens"])
        with use_mesh(mesh, rules):
            o = prefill_attention(
                q[rows, sl], k[rows, sl], v[rows, sl], window=c["window"],
                lens=None if lens is None else lens[rows], impl="ring")
        out[name] = _np(o)
        out[f"{name}/where"] = np.asarray([rows.start, rows.stop, sl.start,
                                           sl.stop])
    return out


def ep_cases(mesh, inputs):
    """``apply_moe_ep`` on this rank's batch rows (over "data") with its
    experts (over "model")."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.ep import apply_moe_ep
    from repro_torch.distributed.sharding import DEFAULT_RULES, use_mesh
    out = {}
    nd, m = mesh.size("data"), mesh.size("model")
    d, r = mesh.index("data"), mesh.index("model")
    rules = DEFAULT_RULES.extend(batch=("data",) if nd > 1 else None)
    for name, c in inputs["cases"].items():
        cfg = get_config("granite-moe-1b-a400m").smoke().replace(
            moe_capacity=c["capacity"], moe_ep=True)
        E = cfg.n_experts
        ex = slice(r * E // m, (r + 1) * E // m)
        p = {k: torch.from_numpy(v) if k == "router"
             else torch.from_numpy(v)[ex].contiguous()
             for k, v in c["p"].items()}
        x = torch.from_numpy(c["x"])
        rows = slice(d * x.shape[0] // nd, (d + 1) * x.shape[0] // nd)
        live = c.get("live")
        with use_mesh(mesh, rules):
            o, aux = apply_moe_ep(p, x[rows], cfg, live=None if live is None
                                  else torch.from_numpy(live)[rows])
        out[name] = _np(o)
        out[f"{name}/aux"] = float(aux)
        out[f"{name}/rows"] = np.asarray([rows.start, rows.stop])
    return out


def _launch_meshes(mesh):
    """The meshes of the launch cases on a 4-rank world: the (2, 2) mesh
    itself, and a (1, 2) and a (2, 1) mesh on each pair of ranks {0, 1}
    and {2, 3} (two replicas of each; every rank makes every group, in
    one order)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import Mesh
    names = ("data", "model")
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    g = pairs[mesh.rank // 2]
    out = {(2, 2): mesh}
    for shape, axis in (((1, 2), "model"), ((2, 1), "data")):
        out[shape] = Mesh(shape, names, rank=mesh.rank % 2,
                          groups={(axis,): g, names: g})
    return out


def _max_rel(got, want):
    """max |got - want| / (1 + |want|) over two trees of tensors."""
    return max(float(((g.double() - w.double()).abs()
                      / (1 + w.double().abs())).max())
               for g, w in zip(_leaves(got), _leaves(want)))


def _max_abs(got, want):
    return max(float((g.double() - w.double()).abs().max())
               for g, w in zip(_leaves(got), _leaves(want)))


def _train_case(mesh, c):
    """One train case under its plan on ``mesh``: the rank's gradients
    (``train_grads``) against the JAX gradients of the whole batch cut to
    the rank, then ``c["steps"]`` steps of ``build_train_step`` against
    one device's plain step on the whole batch, cut to the rank."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import (build_train_step, plan_for,
                                          shard_batch, train_grads)
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.training import TrainState
    from repro_torch.utils.tree import tree_map
    cfg = get_config(c["config"]).smoke().replace(**c["replace"])
    batch = {k: torch.from_numpy(v) for k, v in c["batch"].items()}
    B, S = batch["inputs"].shape
    run = RunConfig(model=cfg, seq_len=S, global_batch=B, kind="train")
    plan = plan_for(run, mesh, attn_impl="ref",
                    microbatches=c["microbatches"],
                    zero_pod=c.get("zero_pod", False), **c.get("plan", {}))
    if c.get("attn"):  # a cut the plan would not pick on this mesh
        plan = dataclasses.replace(plan, layout=dataclasses.replace(
            plan.layout, attn=(c["attn"],) * cfg.n_layers))
    step, _, specs, model = build_train_step(run, plan, torch.float32)
    full = params_from_numpy(c["params"], "cpu")
    params = model.shard_params(full, plan)
    mine = shard_batch(batch, plan)
    loss, parts, grads = train_grads(model, plan)(params, mine)
    want = model.shard_params(params_from_numpy(c["grads"], "cpu"), plan)
    out = {"loss": float(loss), "ce": float(parts["ce"]),
           "aux": float(parts["aux"]), "grad_err": _max_rel(grads, want),
           "microbatches": plan.microbatches, "attn": plan.layout.attn,
           "seq": plan.layout.seq, "ring": plan.layout.ring,
           "attn_impl": plan.attn_impl,
           "vocab": plan.layout.vocab, "fsdp": plan.layout.fsdp,
           "moe": plan.layout.moe(),
           "param_frac": sum(x.numel() for x in _leaves(params))
           / sum(x.numel() for x in _leaves(full))}
    if "against" in c:  # the same step under another plan's knobs
        alt = plan_for(run, mesh, attn_impl="ref",
                       microbatches=c["microbatches"], **c["against"])
        g_alt = train_grads(model, alt)(params, mine)[2]
        out["against_err"] = _max_rel(g_alt, want)
        out["against_diff"] = _max_abs(g_alt, grads)
        out["against_seq"] = alt.layout.seq
    out["rec_rows"] = [int(p["rec"]["wa"].shape[0])
                       for p in params["layers"] if "rec" in p]
    moe = [li for li, p in enumerate(full["layers"]) if "moe" in p]
    if moe:  # the experts a rank holds, of the whole
        out["experts"] = [[int(params["layers"][li]["moe"][k].shape[0])
                           for li in moe for k in ("wg", "wu", "wd")],
                          int(full["layers"][moe[0]]["moe"]["wg"].shape[0])]
    one_plan = plan_for(run, make_local_mesh(), attn_impl="ref",
                        microbatches=1)
    one_step = build_train_step(run, one_plan, torch.float32)[0]
    # each step donates its state (AdamW in place): copies of their own
    st, one = (TrainState.create(tree_map(torch.clone, p))
               for p in (params, full))
    if plan.zero_pod:  # the rank's pieces of the moments
        from repro_torch.distributed.sharding import shard_tensor
        mu = tree_map(lambda t, sp: shard_tensor(torch.zeros_like(t), sp,
                                                 mesh), full,
                      specs["state"].opt.mu)
        st = TrainState(st.params, st.opt._replace(
            mu=mu, nu=tree_map(torch.zeros_like, mu)), st.step)
        out["mu_frac"] = sum(x.numel() for x in _leaves(mu)) / sum(
            x.numel() for x in _leaves(full))
    stats0 = dict(mesh.stats["calls"])
    out["param_err"], out["gnorm"], out["one_gnorm"] = [], [], []
    for _ in range(c["steps"]):
        st, m = step(st, mine)
        one, m1 = one_step(one, batch)
        out["param_err"].append(_max_abs(
            st.params, model.shard_params(one.params, plan)))
        out["gnorm"].append(float(m["grad_norm"]))
        out["one_gnorm"].append(float(m1["grad_norm"]))
    out["calls"] = {k: n - stats0.get(k, 0)
                    for k, n in mesh.stats["calls"].items()}
    if moe:  # and their moments after the steps
        out["expert_moments"] = [
            int(t["layers"][li]["moe"][k].shape[0]) for t in (
                st.opt.mu, st.opt.nu) for li in moe for k in ("wg", "wu",
                                                               "wd")]
    return out


def _prefilled(mesh, c, forced=True, **decode_knobs):
    """The rank's rows of case ``c`` prefilled under the prefill plan
    (``build_prefill_step``) into a state of its rows and kv heads, and
    the decode plan (with ``decode_knobs``) and step after it: a dict of
    the plans, the model, the rank's params, its rows (with the forced
    tokens when ``forced``), the prefill's logits and state."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.steps import (build_prefill_step,
                                          build_serve_step, local_run,
                                          plan_for, shard_batch)
    from repro_torch.models.convert import sharded_params_from_numpy
    cfg = get_config(c["config"]).smoke().replace(**c["replace"])
    tokens, lens = torch.from_numpy(c["tokens"]), torch.from_numpy(c["lens"])
    B, S = tokens.shape
    prun = RunConfig(model=cfg, seq_len=S, global_batch=B, kind="prefill")
    drun = RunConfig(model=cfg, seq_len=S + c["steps"], global_batch=B,
                     kind="decode")
    pplan = plan_for(prun, mesh, scheme=c["scheme"], **c.get("plan", {}))
    dplan = plan_for(drun, mesh, scheme=c["scheme"], **decode_knobs)
    pstep, _, _, model = build_prefill_step(prun, pplan)
    params = sharded_params_from_numpy(c["params"], model, pplan,
                                       device="cpu")
    rows = {"tokens": tokens, "lens": lens}
    if forced:
        rows["forced"] = torch.from_numpy(c["forced"]).T
    mine = shard_batch(rows, pplan)
    state = model.init_decode_state(local_run(drun, pplan), device="cpu",
                                    plan=pplan)
    b, pps = state["tables"].shape[0], state["tables"].shape[2]
    state["tables"] = torch.arange(b * pps, dtype=torch.int32).reshape(
        b, 1, pps)
    logits, state = pstep(params, mine["tokens"], mine["lens"], state)
    return dict(pplan=pplan, dplan=dplan, model=model, params=params,
                mine=mine, logits=logits, state=state, rows=b,
                sstep=build_serve_step(drun, dplan)[0])


def _prefill_case(mesh, c):
    """One prefill case: the rank's rows prefilled under the prefill
    plan (``_prefilled``), ``shard_decode_state`` to the decode plan,
    then ``c["steps"]`` decode steps teacher-forced by the reference's
    greedy tokens; the decode steps' collectives (calls and bytes by op)
    and the shapes of the recurrent state, if any, after the prefill and
    after ``shard_decode_state``."""
    from repro_torch.distributed.collectives import shard_decode_state
    from repro_torch.models.convert import sharded_params_from_numpy
    p = _prefilled(mesh, c)
    pplan, dplan, params, state = (p["pplan"], p["dplan"], p["params"],
                                   p["state"])
    out = {"prefill": _np(p["logits"]), "scheme": dplan.scheme,
           "attn": pplan.layout.attn, "fsdp": pplan.layout.fsdp,
           "seq": pplan.layout.seq, "ring": pplan.layout.ring,
           "wq": next(tuple(q["attn"]["wq"].shape)
                      for q in params["layers"] if "attn" in q),
           "pool_heads": state["k_pages"].shape[3], "rows": p["rows"],
           "row0": pplan.mesh.flat_index(pplan.batch_axes)
           if pplan.batch_axes else 0}
    if "rec" in state:
        out["rec_prefill"] = {k: tuple(v.shape)
                              for k, v in state["rec"]["R"].items()}
    state = shard_decode_state(state, dplan)
    if "rec" in state:
        out["rec_decode"] = {k: tuple(v.shape)
                             for k, v in state["rec"]["R"].items()}
    if pplan.layout.attn != dplan.layout.attn:  # the ring prefill's whole
        params = sharded_params_from_numpy(c["params"], p["model"], dplan,
                                           device="cpu")
    stats0 = {k: dict(mesh.stats[k]) for k in ("calls", "bytes")}
    steps = []
    for i in range(c["steps"]):
        logits, state = p["sstep"](params, p["mine"]["forced"][:, i].int(),
                                   state)
        steps.append(_np(logits))
    out["steps"] = np.stack(steps)
    for k in ("calls", "bytes"):
        out[f"decode_{k}"] = {op: n - stats0[k].get(op, 0)
                              for op, n in mesh.stats[k].items()
                              if n - stats0[k].get(op, 0)}
    return out


def _autograd_collectives(mesh):
    """The collectives under autograd on a (1, 2) mesh: under no_grad
    each equals the plain collective bit for bit; with grad, f's backward
    sums over "model", g's and the gather's pass the rank's share."""
    import torch
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.sharding import use_mesh
    r = mesh.index("model")
    gen = torch.Generator().manual_seed(11 + r)
    x = torch.randn(3, 5, generator=gen)
    out = {}
    with use_mesh(mesh):
        with torch.no_grad():
            out["nograd_equal"] = (
                torch.equal(coll.reduce_sum(x, ("model",)),
                            coll.all_reduce(x, ("model",)))
                and torch.equal(coll.gather_last(x, ("model",)), torch.cat(
                    list(coll.all_gather(x, ("model",))), dim=-1))
                and coll.copy_in(x, ("model",)) is x)
        xs = x.clone().requires_grad_()
        y = coll.gather_last(coll.copy_in(xs, ("model",)) * (r + 1),
                             ("model",))
        w = torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape)
        (gx,) = torch.autograd.grad((y * w).sum(), xs)
        xr = x.clone().requires_grad_()
        (gr,) = torch.autograd.grad((coll.reduce_sum(xr, ("model",))
                                     * w[:, :5]).sum(), xr)
    out["copy_gather_grad"] = _np(gx)
    out["reduce_grad"] = _np(gr)
    return out


def launch_cases(mesh, inputs):
    """Every case of tests/test_torch_launch_ranks.py on a 4-rank world,
    each on its mesh (``_launch_meshes``: every rank is in one replica of
    each)."""
    meshes = _launch_meshes(mesh)
    out = {"coll": _autograd_collectives(meshes[(1, 2)])}
    for name, c in inputs["train"].items():
        out[f"train/{name}"] = _train_case(meshes[c["mesh"]], c)
    for name, c in inputs["prefill"].items():
        out[f"prefill/{name}"] = _prefill_case(meshes[c["mesh"]], c)
    return out


def gspmd_cases(mesh, inputs):
    """Every case of tests/test_torch_gspmd_layouts.py on a 4-rank world:
    the train and prefill cases on their meshes — (2, 2), (1, 2) and
    (2, 1) (``_launch_meshes``), (1, 4) and the (2, 2, 1) ("pod", "data",
    "model") mesh over the four ranks."""
    from repro_torch.launch.mesh import make_mesh
    meshes = _launch_meshes(mesh)
    meshes[(1, 4)] = make_mesh((1, 4))
    meshes[(2, 2, 1)] = make_mesh((2, 2, 1), ("pod", "data", "model"))
    out = {}
    for name, c in inputs["train"].items():
        out[f"train/{name}"] = _train_case(meshes[c["mesh"]], c)
    for name, c in inputs["prefill"].items():
        out[f"prefill/{name}"] = _prefill_case(meshes[c["mesh"]], c)
    return out


def _moe_layer_case(mesh, c):
    """The smoke granite-moe layer (``c["p"]``, whole) on this rank: its
    batch rows of ``c["x"]`` (over "data") with its E/m experts (over
    "model"), under ``ep.apply_moe_ep`` (``c["ep"]``) or GSPMD's cut
    (``moe.apply_moe_train(cut=True)``, the whole batch's aux loss); the
    loss ``Σ out·w + 0.01·aux`` of its rows, differentiated by autograd,
    and the router's and experts' gradients summed over "data" as
    ``train_grads`` sums them."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.collectives import all_reduce
    from repro_torch.distributed.ep import apply_moe_ep
    from repro_torch.distributed.sharding import DEFAULT_RULES, use_mesh
    from repro_torch.models.moe import apply_moe_train
    nd, m = mesh.size("data"), mesh.size("model")
    d, r = mesh.index("data"), mesh.index("model")
    cfg = get_config("granite-moe-1b-a400m").smoke().replace(
        moe_capacity=c["capacity"], moe_ep=c["ep"])
    E = cfg.n_experts
    ex = slice(r * E // m, (r + 1) * E // m)
    p = {k: (torch.from_numpy(v) if k == "router"
             else torch.from_numpy(v)[ex].clone()).requires_grad_()
         for k, v in c["p"].items()}
    x, w = torch.from_numpy(c["x"]), torch.from_numpy(c["w"])
    rows = slice(d * x.shape[0] // nd, (d + 1) * x.shape[0] // nd)
    xr = x[rows].clone().requires_grad_()
    ba = ("data",) if nd > 1 else ()
    names = ("router", "wg", "wu", "wd")
    with use_mesh(mesh, DEFAULT_RULES.extend(batch=ba or None)):
        if c["ep"]:
            o, aux = apply_moe_ep(p, xr, cfg)
        else:
            o, aux = apply_moe_train(p, xr, cfg, ba, cut=True)
        loss = (o * w[rows]).sum() + 0.01 * aux
        g = torch.autograd.grad(loss, [xr] + [p[k] for k in names])
        g = [g[0]] + [all_reduce(t, ba) for t in g[1:]]
    out = {"out": _np(o), "aux": float(aux), "x": _np(g[0]),
           "rows": [rows.start, rows.stop], "experts": [ex.start, ex.stop]}
    out.update({k: _np(t) for k, t in zip(names, g[1:])})
    return out


def _ep_trains(mesh):
    """The smoke granite-moe under ``moe_ep`` on a (1, 2) mesh, B 2 x S 16,
    ``attn_impl="ref"`` (the plan the port refused to train before expert
    parallelism under grad): the layout and the loss's gradients."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.steps import plan_for, train_grads
    from repro_torch.models.api import build_model
    cfg = get_config("granite-moe-1b-a400m").smoke().replace(moe_ep=True)
    run = RunConfig(model=cfg, seq_len=16, global_batch=2, kind="train")
    plan = plan_for(run, mesh, attn_impl="ref")
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0),
                               plan=plan)
    gen = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (2, 17), generator=gen)
    loss, parts, grads = train_grads(model, plan)(
        params, {"inputs": tok[:, :-1], "targets": tok[:, 1:]})
    return {"moe": plan.layout.moe(), "loss": float(loss),
            "aux": float(parts["aux"]),
            "finite": all(bool(torch.isfinite(g).all())
                          for g in _leaves(grads)),
            "nonzero": all(bool(g.abs().sum() > 0) for g in _leaves(
                [lp["moe"] for lp in grads["layers"]]))}


def expert_cases(mesh, inputs):
    """Every case of tests/test_torch_expert_grad.py on a 4-rank world:
    the layer cases (``_moe_layer_case``), the train cases
    (``_train_case``), the prefill cases (``_prefill_case``), the (1, 2)
    plan that trains under ``moe_ep`` and the dry cases, each on its mesh:
    (2, 2), (1, 2) and (2, 1) (``_launch_meshes``), (1, 4) and the (2, 1,
    2) ("pod", "data", "model") mesh over the four ranks."""
    from repro_torch.launch.mesh import make_mesh
    meshes = _launch_meshes(mesh)
    meshes[(1, 4)] = make_mesh((1, 4))
    meshes[(2, 1, 2)] = make_mesh((2, 1, 2), ("pod", "data", "model"))
    out = {f"layer/{name}": _moe_layer_case(meshes[c["mesh"]], c)
           for name, c in inputs["layer"].items()}
    for name, c in inputs["train"].items():
        out[f"train/{name}"] = _train_case(meshes[c["mesh"]], c)
    for name, c in inputs["prefill"].items():
        out[f"prefill/{name}"] = _prefill_case(meshes[c["mesh"]], c)
    out["ep_trains"] = _ep_trains(meshes[(1, 2)])
    out["dry"] = _dry_cases(meshes, inputs["dry"], mesh.rank)
    return out


# ---------------------------------------------------------------------------
# the dry run (tests/test_torch_dryrun.py)
# ---------------------------------------------------------------------------
def real_inputs(run, mine, seed):
    """Real CPU tensors of the shapes of a rank's meta inputs
    (``launch.steps.rank_inputs``): small positive floats, token ids,
    every prompt at its full length (so that a boolean-mask write keeps
    what the dry run's upper bound keeps), each row's pages in order and
    decode positions at the last slot of the sequence."""
    import torch
    from repro_torch.utils.tree import tree_map
    gen = torch.Generator().manual_seed(seed)
    V = run.model.vocab_size

    def fill(t):
        if t.dtype.is_floating_point:
            return (torch.randn(t.shape, generator=gen) * 0.02).abs().to(
                t.dtype)
        return torch.zeros(t.shape, dtype=t.dtype)

    out = []
    for name, tree in mine.items():
        tree = tree_map(fill, tree)
        if name == "batch":
            tree = {k: torch.randint(0, V, v.shape, generator=gen,
                                     dtype=torch.int32)
                    for k, v in tree.items()}
        elif name == "tokens":
            tree = torch.randint(0, V, tree.shape, generator=gen,
                                 dtype=torch.int32)
        elif name == "lens":
            tree = torch.full(tree.shape, run.seq_len, dtype=torch.int32)
        elif name == "state" and run.kind != "train":
            b, _, pps = tree["tables"].shape
            tree["tables"] = torch.arange(b * pps, dtype=torch.int32
                                          ).reshape(b, 1, pps)
            if run.kind == "decode":
                tree["pos"].fill_(run.seq_len - 1)
        out.append(tree)
    return out


def _record(rec):
    from repro_torch.launch.cost_analysis import memory_stats
    return {"flops": rec.flops, "bytes": rec.bytes,
            "memory": memory_stats(rec),
            "calls": dict(rec.stats["calls"]) if rec.stats else {},
            "coll_bytes": dict(rec.stats["bytes"]) if rec.stats else {},
            "kernels": dict(rec.kernels.launches)}


def dryrun_cases(mesh, inputs):
    """Each case of ``inputs["cases"]`` (name: (mesh shape, kind, scheme,
    config[, replace]), the smoke config of that name, with ``replace``'s
    fields when given) on its mesh of this 4-rank
    world ((1, 1): the rank alone; (1, 2), (2, 1) and (2, 2):
    ``_launch_meshes``): the real step on real CPU tensors under
    ``record_step`` and the dry trace of the same rank (``dry_step`` on
    ``make_dry_mesh`` of the same shape and rank), both under
    ``impl="ref"``."""
    from repro_torch.launch.mesh import make_local_mesh
    meshes = _launch_meshes(mesh)
    meshes[(1, 1)] = make_local_mesh()
    return _dry_cases(meshes, inputs, mesh.rank)


def _dry_cases(meshes, inputs, seed):
    """``dryrun_cases`` on the meshes by shape of ``meshes``; ``seed``
    draws the real inputs."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.cost_analysis import record_step
    from repro_torch.launch.mesh import make_dry_mesh
    from repro_torch.launch.steps import dry_step, plan_for, rank_inputs
    out = {}
    for name, (shape, kind, scheme, config, *more) in inputs[
            "cases"].items():
        m = meshes[shape]
        # more: the config's replaced fields, then the plan's knobs
        repl, knobs = (list(more) + [{}, {}])[:2]
        cfg = get_config(config).smoke().replace(**repl)
        run = RunConfig(model=cfg, seq_len=inputs["S"],
                        global_batch=inputs["B"], kind=kind)
        kw = {} if kind == "train" else {"impl": "ref"}
        plan = plan_for(run, m, attn_impl="ref", scheme=scheme, **knobs)
        step, mine, _ = rank_inputs(run, plan, torch.float32, **kw)
        real = record_step(step, real_inputs(run, mine, seed=seed), m)
        dry_plan = plan_for(run, make_dry_mesh(shape, m.axis_names, m.rank),
                            attn_impl="ref", scheme=scheme, **knobs)
        dry = dry_step(run, dry_plan, torch.float32, **kw)
        out[name] = {"real": _record(real), "dry": _record(dry),
                     "scheme": plan.scheme, "seq": plan.layout.seq,
                     "ring": plan.layout.ring}
    return out


def zero_pod_case(mesh, inputs):
    """On a (2, 1, 1) ("pod", "data", "model") mesh over the 2 ranks: the
    smoke llama2-7b trained ``inputs["steps"]`` steps by the ZeRO-1 plan
    and by the plain plan from the same weights and batches; the ZeRO-1
    params, the plain ones and the moments' shapes."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_train_step, plan_for, shard_batch
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.training import TrainState
    from repro_torch.utils.tree import tree_leaves, tree_paths
    pod = make_mesh((2, 1, 1), ("pod", "data", "model"))
    cfg = get_config("llama2-7b").smoke()
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in inputs["batches"]]
    B, S = batches[0]["inputs"].shape
    run = RunConfig(model=cfg, seq_len=S, global_batch=B, kind="train")
    out = {}
    for name, zp in (("zero_pod", True), ("plain", False)):
        plan = plan_for(run, pod, attn_impl="ref", zero_pod=zp)
        step = build_train_step(run, plan, torch.float32)[0]
        st = TrainState.create(params_from_numpy(inputs["params"], "cpu"))
        if zp:  # the rank's slices of the moments
            from repro_torch.launch.steps import train_state_shardings
            from repro_torch.models.api import build_model
            from repro_torch.distributed.sharding import shard_tensor
            from repro_torch.utils.tree import tree_map
            specs = train_state_shardings(build_model(cfg), plan)
            cut = tree_map(lambda t, s: shard_tensor(t, s, pod),
                           st.opt.mu, specs.opt.mu)
            st = TrainState(st.params, st.opt._replace(
                mu=cut, nu=tree_map(torch.zeros_like, cut)), st.step)
        for b in batches:
            st, _ = step(st, shard_batch(b, plan))
        out[name] = {p: _np(x) for p, x in tree_paths(st.params)}
        out[f"{name}/mu"] = {p: tuple(x.shape)
                             for p, x in tree_paths(st.opt.mu)}
        out[f"{name}/gathers"] = pod.stats["calls"]["all_gather"]
        assert len(tree_leaves(st.opt.nu)) == len(tree_leaves(st.opt.mu))
    return out


# ---------------------------------------------------------------------------
# sequence parallelism and ring attention (tests/test_torch_seq_parallel.py)
# ---------------------------------------------------------------------------
def _ring_grad_case(mesh, c):
    """``prefill_attention(impl="ring")`` under autograd on this rank's
    sequence slice (slice r of "model") of its batch rows (over "data"):
    the output and the gradients of q, k and v of ``Σ o·w`` summed over
    every rank (each rank differentiates its own term; the ring's
    backward brings the other ranks' parts of its k and v)."""
    import torch
    from repro_torch.core.attention import prefill_attention
    from repro_torch.distributed.sharding import DEFAULT_RULES, use_mesh
    nd, m = mesh.size("data"), mesh.size("model")
    d, r = mesh.index("data"), mesh.index("model")
    rules = DEFAULT_RULES.extend(batch=("data",) if nd > 1 else None,
                                 seq=("model",))
    q, k, v, w = (torch.from_numpy(c[x]) for x in ("q", "k", "v", "w"))
    B, S = q.shape[:2]
    rows = slice(d * B // nd, (d + 1) * B // nd)
    sl = slice(r * S // m, (r + 1) * S // m)
    mine = [t[rows, sl].clone().requires_grad_() for t in (q, k, v)]
    lens = None if c["lens"] is None else torch.from_numpy(c["lens"])[rows]
    with use_mesh(mesh, rules):
        o = prefill_attention(*mine, window=c["window"],
                              softcap=c["softcap"], lens=lens, impl="ring")
        grads = torch.autograd.grad((o * w[rows, sl]).sum(), mine)
    out = {"o": _np(o), "where": [rows.start, rows.stop, sl.start,
                                   sl.stop]}
    out.update({n: _np(g) for n, g in zip(("dq", "dk", "dv"), grads)})
    return out


def seq_parallel_cases(mesh, inputs):
    """Every case of tests/test_torch_seq_parallel.py on a 4-rank world,
    each on its mesh — (2, 2), (1, 2) (``_launch_meshes``) and (1, 4):
    ring attention under grad, the train cases (``_train_case`` under the
    sequence-parallel and ring plans), the prefill cases
    (``_prefill_case``) and the dry cases (``_dry_cases``)."""
    from repro_torch.launch.mesh import make_mesh
    meshes = _launch_meshes(mesh)
    meshes[(1, 4)] = make_mesh((1, 4))
    out = {}
    for name, c in inputs["ring"].items():
        out[f"ring/{name}"] = _ring_grad_case(meshes[c["mesh"]], c)
    for name, c in inputs["train"].items():
        out[f"train/{name}"] = _train_case(meshes[c["mesh"]], c)
    for name, c in inputs["prefill"].items():
        out[f"prefill/{name}"] = _prefill_case(meshes[c["mesh"]], c)
    out["dry"] = _dry_cases(meshes, inputs["dry"], mesh.rank)
    return out


def _ws_case(mesh, c):
    """One weight-stationary decode case: the rank's rows prefilled under
    the prefill plan (``_prefilled``), ``shard_decode_state`` into the
    ``ws_decode`` plan (every row on every rank), then ``c["steps"]``
    decode steps teacher-forced by the reference's greedy tokens, with
    every collective's mesh axes recorded (a spy on ``distributed.
    collectives``) and ``layers.gather_fsdp`` refused during them."""
    import torch
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.collectives import shard_decode_state
    from repro_torch.models import layers
    p = _prefilled(mesh, c, forced=False, ws_decode=True)
    dplan, params = p["dplan"], p["params"]
    state = shard_decode_state(p["state"], dplan)
    out = {"scheme": dplan.scheme, "batch_axes": dplan.batch_axes,
           "kv_axes": dplan.kv_axes, "act_embed": dplan.layout.act_embed,
           "fsdp": dplan.layout.fsdp, "attn": dplan.layout.attn,
           "vocab": dplan.layout.vocab, "mlp": dplan.layout.mlp,
           "moe": dplan.layout.moe(), "prefill_rows": p["rows"],
           "rows": int(state["pos"].shape[0]),
           "table_shape": tuple(state["tables"].shape)}
    names = ("all_reduce", "all_gather", "all_gather_dim", "reduce_scatter",
             "all_to_all")
    orig = {n: getattr(coll, n) for n in names}
    calls = []

    def spy(n):
        def f(x, axes, *a, **k):
            calls.append((n, tuple(axes)))
            return orig[n](x, axes, *a, **k)
        return f

    def refuse(*a, **k):
        raise AssertionError("gather_fsdp under weight-stationary decode")

    gather = layers.gather_fsdp
    steps = []
    try:
        for n in names:
            setattr(coll, n, spy(n))
        layers.gather_fsdp = refuse
        forced = torch.from_numpy(c["forced"])
        for i in range(c["steps"]):
            logits, state = p["sstep"](params, forced[i].int(), state)
            steps.append(_np(logits))
    finally:
        for n in names:
            setattr(coll, n, orig[n])
        layers.gather_fsdp = gather
    out["steps"] = np.stack(steps)
    out["calls"] = calls
    return out


def ws_cases(mesh, inputs):
    """Every case of tests/test_torch_ws_decode.py on a 4-rank world,
    each on its mesh: (2, 2), (2, 1) (``_launch_meshes``) and the
    (2, 2, 1) ("pod", "data", "model") mesh over the four ranks."""
    from repro_torch.launch.mesh import make_mesh
    meshes = _launch_meshes(mesh)
    meshes[(2, 2, 1)] = make_mesh((2, 2, 1), ("pod", "data", "model"))
    return {name: _ws_case(meshes[c["mesh"]], c)
            for name, c in inputs.items()}


# ---------------------------------------------------------------------------
# R layers under a mesh (tests/test_torch_rglru_dist.py)
# ---------------------------------------------------------------------------
def _train_cli_case(mesh, c):
    """``launch.train.train`` of the smoke config ``c["config"]`` on
    ``mesh`` and on the rank alone (the local mesh): the losses of each
    step and the rank's params after them, against the local run's cut
    to the rank."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.steps import plan_for
    from repro_torch.configs.base import RunConfig
    cfg = get_config(c["config"]).smoke()
    kw = dict(steps=c["steps"], batch=c["batch"], seq=c["seq"], lr=1e-3,
              impl="ref", device="cpu", log_every=1, log_fn=lambda s: None)
    st, hist = launch_train.train(cfg, mesh=mesh, **kw)
    one, one_hist = launch_train.train(cfg, **kw)
    run = RunConfig(model=cfg, seq_len=c["seq"], global_batch=c["batch"],
                    kind="train")
    plan = plan_for(run, mesh, attn_impl="ref")
    from repro_torch.models.api import build_model
    want = build_model(cfg).shard_params(one.params, plan)
    return {"losses": [h["loss"] for h in hist],
            "one_losses": [h["loss"] for h in one_hist],
            "param_err": _max_abs(st.params, want), "state": plan.layout.state,
            "rec_wa": tuple(st.params["layers"][0]["rec"]["wa"].shape)}


def rglru_dist_cases(mesh, inputs):
    """Every case of tests/test_torch_rglru_dist.py on a 4-rank world,
    each on its mesh — (2, 2), (1, 2) and (2, 1) (``_launch_meshes``)
    and (1, 4): the train cases (``_train_case`` under the
    sequence-cut, uncut and ring plans), the prefill cases (``_prefill_
    case``: prefill, ``shard_decode_state``, dp decode), the
    weight-stationary ones (``_ws_case``), the dry cases (``_dry_cases``)
    and the train CLI on (1, 2)."""
    from repro_torch.launch.mesh import make_mesh
    meshes = _launch_meshes(mesh)
    meshes[(1, 4)] = make_mesh((1, 4))
    out = {}
    for name, c in inputs["train"].items():
        out[f"train/{name}"] = _train_case(meshes[c["mesh"]], c)
    for name, c in inputs["prefill"].items():
        out[f"prefill/{name}"] = _prefill_case(meshes[c["mesh"]], c)
    for name, c in inputs["ws"].items():
        out[f"ws/{name}"] = _ws_case(meshes[c["mesh"]], c)
    out["dry"] = _dry_cases(meshes, inputs["dry"], mesh.rank)
    c = inputs["cli"]
    out["cli"] = _train_cli_case(meshes[c["mesh"]], c)
    return out
