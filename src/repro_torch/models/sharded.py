"""The model's ops on DTensor shards, under sharding rules.

Under non-empty rules (``common.sharding.logical_rules``: the dry run,
``launch/dryrun.py``) the model's parameters and inputs are DTensors laid
out by the rules, and the model code calls these functions where DTensor's
own sharding rules would not give the reference's layout: a product of a
replicated weight comes out sharded over a mesh dim on its own (a
"negative-cost" choice) and its unflatten into heads then fails where the
heads do not divide the mesh; an index into a sequence-sharded KV cache or
a logsumexp over vocab-sharded logits gathers them whole; some DTensor
versions (torch 2.11) have no rule for a pad, or for tokens sharded over
two mesh dims. Each function runs the op on each device's shards
(``local_map``) with placements chosen from the rules, as GSPMD lays out
the reference's ``dot_general``s, gathers and scans, and states its
gradients' placements (a gradient summed over a mesh dim's shards is
``Partial``). Without rules none of this runs: every caller checks
``sharding.current_rules()`` first, and its unsharded path is the one the
card runs (``settled``, ``whole`` and ``merge_ready`` check themselves,
and return their input without rules). DTensor's modules load on first
use (about a second of import), not with the port.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.common import sharding
from repro_torch.kernels.flash_attention import flash_attention

NEG_INF = -1e30


def dot(x, w, ncon: int, local_dot):
    """``local_dot(x, w, ncon)`` (``member_math.member_dot``) of DTensors,
    on each device's shards (``local_map``), with a layout chosen mesh
    dimension by mesh dimension: x's batch-like (free) axis sharded -> the output's, w gathered there
    (the FSDP gather); both contraction axes sharded -> a ``Partial`` sum;
    x replicated and a free axis of w sharded -> the output's matching
    axis; x replicated and w's contraction sharded -> x sliced to match, a
    ``Partial`` sum; x a ``Partial`` sum -> reduced first. DTensor's own
    product shards a replicated weight's output axis on its own, and the
    unflatten of the product then fails where the heads do not divide the
    mesh."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    nfree = x.dim() - ncon
    mesh = x.device_mesh
    # per mesh dim: x's, w's and the output's placements, and the
    # gradients' (a gradient summed over the dim's shards is Partial)
    px, pw, po, gx, gw = [], [], [], [], []
    for xs, ws in zip(x.placements, w.placements):
        if xs.is_partial():
            xs = Replicate()
        if xs.is_shard() and xs.dim < nfree:
            dims = (xs, Replicate(), Shard(xs.dim), xs, Partial())
        elif xs.is_shard():
            ws = Shard(xs.dim - nfree)
            dims = (xs, ws, Partial(), xs, ws)
        elif ws.is_shard() and ws.dim >= ncon:
            dims = (Replicate(), ws, Shard(nfree + ws.dim - ncon), Partial(),
                    ws)
        elif ws.is_shard():
            xs = Shard(nfree + ws.dim)
            dims = (xs, ws, Partial(), xs, ws)
        else:
            dims = (Replicate(),) * 5
        for acc, p in zip((px, pw, po, gx, gw), dims):
            acc.append(p)

    def local(a, b):
        with sharding.logical_rules(None):     # the shards are plain
            return local_dot(a, b, ncon)

    run = local_map(local, out_placements=po, in_placements=(px, pw),
                    in_grad_placements=(gx, gw), device_mesh=mesh,
                    redistribute_inputs=True)
    return run(x, w)


def flash(q, k, v, causal: bool, window):
    """``flash_attention`` of DTensors under the context's rules: the
    kernel on each device's shard (``local_map``), batch over its axes and
    heads over theirs. When the query heads shard and the kv heads cannot,
    k and v are repeated to the query heads first, so that each shard's
    queries find their kv heads in it. A head_dim or sequence split has no
    local attention and raises."""
    from torch.distributed.tensor.experimental import local_map
    rules = sharding.current_rules()
    qs = rules.mesh_axes(("batch", "seq", "heads", "head_dim"))
    ks = rules.mesh_axes(("batch", "seq", "kv_heads", "head_dim"))
    if qs[1] is not None or qs[3] is not None:
        raise ValueError(f"flash_attention: no local attention for a "
                         f"sequence or head_dim split, spec {qs}")
    if qs[2] is not None and ks[2] is None:
        group = q.shape[2] // k.shape[2]
        k = torch.repeat_interleave(k, group, dim=2)
        v = torch.repeat_interleave(v, group, dim=2)
        ks = qs
    mesh = q.device_mesh
    qp, kp = sharding.placements(qs, mesh), sharding.placements(ks, mesh)
    run = local_map(
        functools.partial(flash_attention, causal=causal, window=window),
        out_placements=qp, in_placements=(qp, kp, kp), device_mesh=mesh,
        redistribute_inputs=True)
    return run(q, k, v)


def decode_attention(q, k_cache, v_cache, valid: int, cache_axes):
    """``layers.decode_attention`` of DTensors, on each device's shards
    (``local_map``): the caches laid out by ``cache_axes``
    (``layers.ATTN_CACHE_AXES``: kv heads, or where they cannot shard, the
    slots: ``cache_seq``), q's heads as the cache's kv heads. The softmax
    comes in its parts, as flash-decoding combines them: each shard's
    scores and their max (a ``Partial`` max over the slots' shards,
    reduced), then each shard's exp-weighted values and their sum
    (``Partial`` sums, reduced), then the quotient. Only (B, H)-sized stats
    and the (B, H, hd) output cross the slots' shards, as in the
    reference's decode; the cache is never gathered."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    rules = sharding.current_rules()
    mesh = k_cache.device_mesh
    spec = rules.mesh_axes(cache_axes)
    pc = sharding.placements(spec, mesh)            # (B, C, Hkv, hd)
    pq = sharding.placements((spec[0], None, spec[2], spec[3]), mesh)
    if any(p.is_shard(3) for p in pc):
        raise ValueError("decode attention: no local attention for a "
                         "head_dim split")
    slots = [i for i, p in enumerate(pc) if p.is_shard(1)]
    # the scores (B, Hkv, G, C) and row stats (B, Hkv, G, 1)
    ps = [Shard(0) if p.is_shard(0) else Shard(3) if p.is_shard(1) else
          Shard(1) if p.is_shard(2) else Replicate() for p in pc]
    pm = [Partial("max") if p.is_shard(3) else p for p in ps]
    pr = [Replicate() if p.is_shard(3) else p for p in ps]
    # the output and the softmax's sum (B, 1, H, ...)
    po = [Shard(0) if p.is_shard(0) else Shard(2) if p.is_shard(2) else
          Partial() if p.is_shard(1) else Replicate() for p in pc]
    coord = mesh.get_coordinate()

    def scores(qq, kk):
        B, C, Hkv, hd = kk.shape
        idx = 0
        for i in slots:
            idx = idx * mesh.size(i) + coord[i]
        qr = qq.reshape(B, Hkv, qq.shape[2] // Hkv, hd).float()
        s = torch.einsum("bhgd,bkhd->bhgk", qr, kk.float()) / math.sqrt(hd)
        live = torch.arange(idx * C, idx * C + C, device=kk.device) < valid
        s = torch.where(live, s, torch.full((), NEG_INF, device=kk.device))
        return s, torch.amax(s, dim=-1, keepdim=True)

    def weigh(s, m, vv):
        p = torch.exp(s - m)
        B, Hkv, G, _ = p.shape
        o = torch.einsum("bhgk,bkhd->bhgd", p, vv.float())
        return (o.reshape(B, 1, Hkv * G, o.shape[-1]),
                torch.sum(p, dim=-1).reshape(B, 1, Hkv * G, 1))
    s, m = local_map(scores, out_placements=(ps, pm), in_placements=(pq, pc),
                     device_mesh=mesh, redistribute_inputs=True)(q, k_cache)
    m = m.redistribute(mesh, pr)
    o, total = local_map(weigh, out_placements=(po, po),
                         in_placements=(ps, pr, pc), device_mesh=mesh,
                         redistribute_inputs=True)(s, m, v_cache)
    done = [Replicate() if p.is_partial() else p for p in po]
    return (o.redistribute(mesh, done) / total.redistribute(mesh, done)) \
        .to(q.dtype)


def write(buf, start: int, val) -> None:
    """``buf[:, start:start + n] = val`` (val (B, n, ...)) of DTensors, in
    place on each device's shard: where a cache shards its slots
    (``cache_seq``), each device writes the slots of the range that it
    holds, and no device gathers the cache (DTensor's own indexing
    would)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = buf.device_mesh
    seq = [i for i, p in enumerate(buf.placements) if p.is_shard(1)]
    pv = [p if p.is_shard() and not p.is_shard(1) else Replicate()
          for p in buf.placements]
    coord = mesh.get_coordinate()

    def local(b, v):
        idx = 0
        for i in seq:
            idx = idx * mesh.size(i) + coord[i]
        lo = idx * b.shape[1]
        a, e = max(start, lo), min(start + v.shape[1], lo + b.shape[1])
        if a < e:
            b[:, a - lo:e - lo] = v[:, a - start:e - start]
        return b

    local_map(local, out_placements=list(buf.placements),
              in_placements=(list(buf.placements), pv), device_mesh=mesh,
              redistribute_inputs=True)(buf, val)


def lookup(table, tokens):
    """``table[tokens]`` of DTensors, on each device's shards: over a mesh
    dim that shards the tokens (their batch), the table is gathered and
    the rows come out sharded as the tokens, and the table's gradient is a
    ``Partial`` sum; over one that shards the table's embed axis, the rows
    keep that axis sharded. DTensor's own gather has no rule for tokens
    sharded over two mesh dims (pure data parallelism) on some versions."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    pt, pk, po, gt = [], [], [], []
    for ts, ks in zip(table.placements, tokens.placements):
        if ks.is_shard():
            dims = (Replicate(), ks, Shard(ks.dim), Partial())
        elif ts.is_shard(1):
            dims = (ts, Replicate(), Shard(tokens.dim()), ts)
        else:
            dims = (Replicate(),) * 4
        for acc, p in zip((pt, pk, po, gt), dims):
            acc.append(p)
    return local_map(lambda t, i: t[i], out_placements=po,
                     in_placements=(pt, pk), in_grad_placements=(gt, pk),
                     device_mesh=table.device_mesh,
                     redistribute_inputs=True)(table, tokens)


def lse_gold(logits, labels):
    """(logsumexp over the vocab, the labels' logits) of DTensor logits
    (N, V) whose vocab axis may be sharded (``_ShardedXent``)."""
    return _ShardedXent.apply(logits, labels)


def _vocab_layout(logits):
    """(the logits' placements, a row vector's (each row's vocab axis
    replicated), the vocab's mesh dims)."""
    from torch.distributed.tensor import Replicate
    pl = [p if p.is_shard() else Replicate() for p in logits.placements]
    return (pl, [Replicate() if p.is_shard(1) else p for p in pl],
            [i for i, p in enumerate(pl) if p.is_shard(1)])


def _on_vocab_shard(logits, labels, fn, out_rows: bool):
    """``fn(local logits, local labels - the shard's first vocab index,
    the shard's vocab width)`` on each device's shard (``local_map``): a
    row vector (a ``Partial`` sum over the vocab's shards) when
    ``out_rows``, else a tensor laid out as the logits."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    pl, pr, vocab = _vocab_layout(logits)
    mesh = logits.device_mesh
    coord = mesh.get_coordinate()

    def local(lg, lab):
        idx = 0
        for i in vocab:
            idx = idx * mesh.size(i) + coord[i]
        return fn(lg, lab.long() - idx * lg.shape[-1], lg.shape[-1])
    po = [Partial() if i in vocab else p for i, p in enumerate(pr)] \
        if out_rows else pl
    return local_map(local, out_placements=po, in_placements=(pl, pr),
                     device_mesh=mesh, redistribute_inputs=True)(logits,
                                                                 labels)


class _ShardedXent(torch.autograd.Function):
    """The cross-entropy's two row terms of vocab-sharded DTensor logits,
    laid out by hand: the log-sum-exp from its parts (a max, then a sum of
    exponentials, each reduced across the vocab's shards; row vectors of
    (N,) floats), each label's logit picked on the shard that holds it, and
    the gradient softmax(x) g_lse + onehot g_gold built on the logits'
    shards. DTensor's own logsumexp gathers the logits, and its backward
    reshards the row vectors' batch axis, gathering them again."""

    @staticmethod
    def forward(ctx, logits, labels):
        pl, pr, _ = _vocab_layout(logits)
        mesh = logits.device_mesh
        m = torch.amax(logits, dim=-1, keepdim=True).redistribute(mesh, pr)
        total = torch.sum(torch.exp(logits - m), dim=-1, keepdim=True)
        lse = (m + torch.log(total.redistribute(mesh, pr)))
        gold = _on_vocab_shard(logits, labels, _pick, True)
        ctx.save_for_backward(logits, labels, lse)
        return lse[..., 0], gold.redistribute(mesh, [p for p in pr])

    @staticmethod
    def backward(ctx, g_lse, g_gold):
        logits, labels, lse = ctx.saved_tensors
        pl, pr, _ = _vocab_layout(logits)
        mesh = logits.device_mesh
        g_lse = g_lse.redistribute(mesh, pr)
        g_gold = g_gold.redistribute(mesh, pr)
        grad = torch.exp(logits - lse) * g_lse[..., None]
        hot = _on_vocab_shard(logits, labels, _hot, False)
        return grad + hot * g_gold[..., None], None


def _pick(lg, j, width):
    """Each row's logit at local index j, 0 where j is off this shard."""
    inside = (j >= 0) & (j < width)
    got = torch.gather(lg, -1, torch.clamp(j, 0, width - 1)[..., None])
    return torch.where(inside, got[..., 0], torch.zeros_like(got[..., 0]))


def _hot(lg, j, width):
    """One-hot rows at local index j (none where j is off this shard)."""
    return (torch.arange(width, device=lg.device) == j[..., None]).to(
        lg.dtype)


def experts(params, buf, g_ax, local_experts):
    """``local_experts(params, buf)`` (``moe._experts``) of DTensors: the
    groups over ``g_ax``'s axes, the experts over ``expert``'s, each
    expert's d_ff over ``expert_mlp``'s (the weights gathered over
    ``embed``'s, the FSDP gather), so that h has the reference's layout
    (``g_ax, expert, expert_capacity, expert_mlp``) and the output is a
    ``Partial`` sum over the d_ff shards, reduced at the caller's
    constraint. DTensor's own einsum shards the expert axis where it does
    not divide the mesh (qwen2-moe's 60 experts) and then cannot flatten
    it."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    rules = sharding.current_rules()
    mesh = buf.device_mesh

    def put(axes):
        return sharding.placements(rules.mesh_axes(axes), mesh)

    pb = put((g_ax, "expert", None, None))
    pin = put(("expert", None, "expert_mlp"))
    pout = put(("expert", "expert_mlp", None))
    # the output and buf's gradient sum over the d_ff shards, the weights'
    # gradients over the groups' shards
    po = [Partial() if p_in.is_shard(2) else p_b
          for p_b, p_in in zip(pb, pin)]
    gw = [[Partial() if p_b.is_shard(0) else p for p_b, p in zip(pb, pws)]
          for pws in (pin, pin, pout)]
    run = local_map(lambda b, wi, wg, wo: local_experts(
        {"w_in": wi, "w_gate": wg, "w_out": wo}, b),
        out_placements=po, in_placements=(pb, pin, pin, pout),
        in_grad_placements=(po, *gw), device_mesh=mesh,
        redistribute_inputs=True)
    with sharding.logical_rules(None):
        return run(buf, params["w_in"], params["w_gate"], params["w_out"])


def group_local(fn, args, ndims_out, g_ax):
    """``fn(*args)`` of DTensors under the context's rules, on each
    device's dispatch groups (``local_map``): the group axis (the first,
    ``g_ax``'s sharding) is the only one that splits, the rest stays whole.
    DTensor has no sharding rule for the plan's scatter into a fresh index
    buffer, and would not keep the gathers local. ``ndims_out`` gives the
    outputs' ranks (an int for one output)."""
    from torch.distributed.tensor.experimental import local_map
    rules = sharding.current_rules()
    mesh = args[0].device_mesh
    spec = rules.mesh_axes((g_ax,))[0]

    def put(nd):
        return sharding.placements((spec,) + (None,) * (nd - 1), mesh)

    def local(*a):
        with sharding.logical_rules(None):
            return fn(*a)
    out = (put(ndims_out) if isinstance(ndims_out, int)
           else tuple(put(n) for n in ndims_out))
    return local_map(local, out_placements=out,
                     in_placements=tuple(put(a.dim()) for a in args),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def settled(*ts):
    """The time loop's inputs as they are; under the context's rules with
    each ``Partial`` sum reduced once (to replicated), before the loop
    slices them: a step would reduce its slice, one collective a step."""
    if sharding.current_rules() is None:
        return ts
    from torch.distributed.tensor import Replicate
    return tuple(t.redistribute(t.device_mesh, [
        Replicate() if p.is_partial() else p for p in t.placements])
        for t in ts)


def fit_groups(rules, G: int, mesh):
    """``rules`` with ``batch`` over the longest prefix of its mesh axes
    whose sizes multiply to a divisor of the MoE's G dispatch groups (the
    rules themselves when they all do), so that each device holds whole
    groups: on the multipod mesh the batch spans pod x data = 32 devices
    for qwen2-moe's 16 groups. The reference's GSPMD pads such a split,
    which leaves rank 0 the same one group."""
    assign = rules.rules.get("batch")
    axes = (assign,) if isinstance(assign, str) else tuple(assign or ())
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    kept, prod = [], 1
    for ax in axes:
        if G % (prod * sizes[ax]):
            break
        kept.append(ax)
        prod *= sizes[ax]
    if len(kept) == len(axes):
        return rules
    return sharding.LogicalRules({**rules.rules, "batch": (
        tuple(kept) if len(kept) > 1 else (kept[0] if kept else None))})


def whole(x, dim: int):
    """``x`` with axis ``dim`` unsharded (replicated over the mesh dims
    that shard it): itself without rules. DTensor shards a replicated
    axis on its own, and some versions then refuse to unbind it."""
    if sharding.current_rules() is None:
        return x
    from torch.distributed.tensor import Replicate
    dim %= x.dim()
    want = [Replicate() if p.is_shard(dim) else p for p in x.placements]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def merge_ready(x, first: int):
    """``x`` ready to merge its axes ``first ..`` (the last ones) into one:
    itself without rules; under rules a DTensor whose merged axes after the
    first are sharded is replicated over those mesh dims (some DTensor
    versions refuse the merge of a sharded minor axis)."""
    if sharding.current_rules() is None:
        return x
    from torch.distributed.tensor import Replicate
    first %= x.dim()
    want = [Replicate() if p.is_shard() and p.dim > first else p
            for p in x.placements]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)
