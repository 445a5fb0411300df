"""Op-level cost counter: the port's counterpart of the reference's
``repro.launch.hlo_cost``.

The reference reads the cost of a step from XLA's optimized HLO, and it
exists because ``compiled.cost_analysis()`` counts a ``while`` body once.
The port has no HLO: it counts the ops the step runs, as they run, with a
``TorchDispatchMode`` (``OpCounter``; ``count(fn, *args)`` returns the
keys of ``hlo_cost.analyze``). Python unrolls every loop, so
``unparsed_loops`` is always 0; on meta tensors, which hold no values to
carry, a loop of identical time steps is folded (``fold``: counted from
two steps), which is the reference's known trip count.

Accounting model, per device:

* flops — products and convolutions by their formulas, ``2 x prod(out) x
  contraction`` (``hlo_cost.py``'s dot and convolution rules);
  elementwise ops one per output element (a compound op such as ``silu``
  or ``_softmax`` the elementwise ops XLA decomposes it into, per element),
  reductions one per input element. ``_TRANSCENDENTAL``'s ops are counted
  as transcendentals too.
* bytes — eager's own traffic model: each op reads its operands and writes
  its result, because no compiler fuses eager ops. ``hlo_cost`` counts
  bytes at XLA's fusion boundaries instead (a fusion reads its inputs once
  and writes its output once), so for the same step this count is the
  larger. Views, allocations and the collectives' waits move nothing.
* collectives — the c10d functional collectives seen (the ones DTensor
  issues when it redistributes), priced by ``hlo_cost._collective_ici``'s
  ring model; their results' bytes count as bytes, as in ``hlo_cost``.
* the port's kernels — the mode cannot see a ctypes launch, so each
  kernel wrapper reports its launch's cost (``report``) from the formula
  beside the kernel: the work the bound column of PERF.md's kernel table
  counts. ``kernels`` holds their counts and costs by name. Without a
  counter, while a profiler records, ``report`` tallies the launch in
  ``common.trace`` instead (``trace.kernel_tally``).

Under DTensor (the dry run, ``launch/dryrun.py``) the mode sees the global
op, of global shapes: its flops are its global flops divided by the
product of the mesh dimensions over which its output is not replicated
(``Shard`` and ``Partial`` both split the work), and its bytes are those of
its operands' and result's local shards. The collectives that DTensor
issues to redistribute the operands are counted from inside the op.
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.common import trace

# what the reference counts as transcendental (hlo_cost._TRANSCENDENTAL),
# by aten name, with the transcendentals an element of each op needs
_TRANSCENDENTAL = {
    "exp": 1, "exp2": 1, "expm1": 1, "log": 1, "log1p": 1, "log2": 1,
    "tanh": 1, "sqrt": 1, "rsqrt": 1, "pow": 1, "sigmoid": 1, "cos": 1,
    "sin": 1, "erf": 1, "atan2": 1, "silu": 1, "gelu": 1, "softplus": 2,
    "_softmax": 1, "_log_softmax": 2, "logsumexp": 2, "silu_backward": 1,
    "gelu_backward": 1, "softplus_backward": 1, "tanh_backward": 0,
    "sigmoid_backward": 0,
}
# elementwise ops: flops an output element (the ops XLA's decomposition
# of a compound op counts)
_ELEMENTWISE = {
    "add": 1, "sub": 1, "rsub": 1, "mul": 1, "div": 1, "neg": 1, "abs": 1,
    "maximum": 1, "minimum": 1, "clamp": 1, "clamp_min": 1, "clamp_max": 1,
    "where": 1, "eq": 1, "ne": 1, "lt": 1, "le": 1, "gt": 1, "ge": 1,
    "logical_and": 1, "logical_or": 1, "logical_not": 1, "bitwise_and": 1,
    "bitwise_or": 1, "bitwise_xor": 1, "bitwise_not": 1, "sign": 1,
    "floor": 1, "ceil": 1, "round": 1, "remainder": 1, "fmod": 1,
    "reciprocal": 1, "square": 1, "relu": 1, "threshold_backward": 1,
    "exp": 1, "exp2": 1, "expm1": 1, "log": 1, "log1p": 1, "log2": 1,
    "tanh": 1, "sqrt": 1, "rsqrt": 1, "pow": 1, "sigmoid": 1, "cos": 1,
    "sin": 1, "erf": 1, "atan2": 1, "_to_copy": 1, "fill": 1,
    "addcmul": 2, "addcdiv": 2, "lerp": 2, "silu": 2, "softplus": 3,
    "gelu": 8, "tanh_backward": 2, "sigmoid_backward": 2,
    "silu_backward": 4, "gelu_backward": 10, "softplus_backward": 4,
    "masked_fill": 1,
}
# reductions: flops an input element
_REDUCTION = {
    "sum": 1, "mean": 1, "amax": 1, "amin": 1, "max": 1, "min": 1,
    "argmax": 1, "argmin": 1, "prod": 1, "cumsum": 1, "var": 3,
    "var_mean": 3, "std": 3, "norm": 2, "linalg_vector_norm": 2,
    "any": 1, "all": 1, "logsumexp": 4, "_softmax": 5, "_log_softmax": 4,
    "_softmax_backward_data": 3, "_log_softmax_backward_data": 3,
}
# ops that move no data: views, allocations, metadata, waits
_FREE = {
    "empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
    "view", "_unsafe_view", "reshape", "alias", "as_strided", "t",
    "transpose", "permute", "expand", "slice", "select", "unsqueeze",
    "squeeze", "detach", "split", "split_with_sizes", "unbind", "chunk",
    "narrow", "diagonal", "unfold", "lift_fresh", "view_as", "_reshape_alias",
    "sym_size", "sym_stride", "sym_numel", "is_same_size", "_local_scalar_dense",
    "wait_tensor", "_wrap_tensor_autograd", "set_", "resize_", "conj",
    "_conj", "_neg_view", "resolve_conj", "resolve_neg", "real", "imag",
    "view_as_real", "view_as_complex", "_has_compatible_shallow_copy_type",
    "record_stream", "dim", "size", "stride", "numel",
}
_MATMUL = {"mm", "addmm", "bmm", "baddbmm", "dot", "mv", "addmv", "addbmm",
           "vdot"}
# c10d functional collectives -> hlo_cost's collective names
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "collective-permute",
}

_ACTIVE: list = []     # the counters in use, innermost last


def _collective_ici(op: str, out_bytes: float, g: int) -> float:
    """Bytes a device sends over the interconnect for one collective of
    result ``out_bytes`` on a group of ``g``: the reference's ring model
    (``hlo_cost._collective_ici``)."""
    if g <= 1:
        return 0.0
    if op == "all-gather":
        return out_bytes * (g - 1) / g
    if op == "all-reduce":
        return 2.0 * out_bytes * (g - 1) / g
    if op == "reduce-scatter":
        return float(out_bytes) * (g - 1)
    if op == "all-to-all":
        return out_bytes * (g - 1) / g
    return float(out_bytes)  # collective-permute


def _name(func) -> str:
    name = func._overloadpacket.__name__ if hasattr(func, "_overloadpacket") \
        else str(func)
    return name[:-1] if name.endswith("_") and not name.startswith("_") \
        else name


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _numel(t) -> int:
    return math.prod(t.shape)


def _nbytes(t) -> int:
    """Bytes of a tensor's storage on this device: the local shard of a
    DTensor."""
    local = getattr(t, "_local_tensor", t)
    return math.prod(local.shape) * local.element_size()


def _group_size(name: str, args, default: int) -> int:
    if name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
        for a in args[1:]:
            if isinstance(a, int):
                return a
    if name == "all_to_all_single" and isinstance(args[1], (list, tuple)) \
            and args[1]:
        return len(args[1])
    try:
        from torch.distributed.distributed_c10d import _resolve_process_group
        return _resolve_process_group(args[-1]).size()
    except Exception:
        return default


def op_flops(name: str, args, out) -> tuple:
    """(flops, transcendentals) of one aten op at the shapes of its
    operands and result (global shapes for a DTensor op)."""
    outs = _tensors(out)
    if name in _MATMUL:
        ins = [a for a in args if isinstance(a, torch.Tensor)]
        k = ins[-1].shape[-2] if ins[-1].dim() >= 2 else ins[-1].shape[0]
        return 2.0 * _numel(outs[0]) * k, 0.0
    if name == "convolution":
        x, w = args[0], args[1]
        groups = args[8] if len(args) > 8 else 1
        per_out = (x.shape[1] // groups) * math.prod(w.shape[2:])
        return 2.0 * _numel(outs[0]) * per_out, 0.0
    if name == "convolution_backward":
        w = args[2]
        mask = args[-1] if isinstance(args[-1], (list, tuple)) else (1, 1, 1)
        gy = args[0]
        groups = args[9] if len(args) > 9 else 1
        per_out = (w.shape[1]) * math.prod(w.shape[2:])
        one = 2.0 * _numel(gy) * per_out
        return one * (int(bool(mask[0])) + int(bool(mask[1]))), 0.0
    trans = _TRANSCENDENTAL.get(name, 0)
    if name in _REDUCTION:
        n = sum(_numel(a) for a in args[:1] if isinstance(a, torch.Tensor))
        return float(_REDUCTION[name] * n), float(trans * n)
    if name in _ELEMENTWISE and outs:
        n = _numel(outs[0])
        return float(_ELEMENTWISE[name] * n), float(trans * n)
    return 0.0, 0.0


class OpCounter(TorchDispatchMode):
    """Counts the flops, bytes, transcendentals and collectives of the ops
    run inside it (see the module docstring), and the kernels' reports.
    ``world`` is the group size a collective without one is priced at."""

    def __init__(self, world: int = 1):
        super().__init__()
        self.world = world
        self.flops = 0.0
        self.bytes = 0.0
        self.transcendentals = 0.0
        self.ici_bytes = 0.0
        self.collectives: Dict[str, Dict[str, float]] = {}
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.by_op: Dict[str, list] = defaultdict(lambda: [0.0, 0.0, 0.0])
        self._mult = [1.0]

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    # -- what the mode sees -------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        dt = _dtensor_type()
        if dt is not None and any(issubclass(t, dt) for t in types):
            with _Collectives(self):
                out = func(*args, **kwargs)
            self._count_op(func, args, kwargs, out, _split_of(out, dt))
            return out
        out = func(*args, **kwargs)
        self._count_op(func, args, kwargs, out, 1)
        return out

    def _count_op(self, func, args, kwargs, out, split: int) -> None:
        name = _name(func)
        if func.namespace in ("_c10d_functional", "c10d_functional",
                              "_c10d_functional_autograd", "c10d"):
            self._count_collective(name, args, out)
            return
        if name in _FREE:
            return
        m = self._mult[-1]
        flops, trans = op_flops(name, args, out)
        nbytes = sum(_nbytes(t) for t in _tensors((args, kwargs))) \
            + sum(_nbytes(t) for t in _tensors(out))
        if name in ("copy", "fill", "zero"):     # in place: read src, write
            nbytes = sum(_nbytes(t) for t in _tensors(args[1:])) \
                + sum(_nbytes(t) for t in _tensors(out))
        self.flops += m * flops / split
        self.transcendentals += m * trans / split
        self.bytes += m * nbytes
        row = self.by_op[name]
        row[0] += m
        row[1] += m * flops / split
        row[2] += m * nbytes

    def _count_collective(self, name: str, args, out) -> None:
        op = _COLLECTIVES.get(name)
        if op is None:
            return
        m = self._mult[-1]
        out_bytes = sum(_nbytes(t) for t in _tensors(out))
        ici = _collective_ici(op, out_bytes, _group_size(name, args,
                                                         self.world))
        s = self.collectives.setdefault(
            op, {"count": 0.0, "out_bytes": 0.0, "ici_bytes": 0.0})
        s["count"] += m
        s["out_bytes"] += m * out_bytes
        s["ici_bytes"] += m * ici
        self.ici_bytes += m * ici
        self.bytes += m * out_bytes

    # -- kernels and folds --------------------------------------------------

    def add_kernel(self, name: str, flops: float, nbytes: float,
                   transcendentals: float = 0.0, int_ops: float = 0.0) -> None:
        m = self._mult[-1]
        k = self.kernels.setdefault(name, {"count": 0.0, "flops": 0.0,
                                           "bytes": 0.0, "int_ops": 0.0,
                                           "transcendentals": 0.0})
        k["count"] += m
        k["flops"] += m * flops
        k["bytes"] += m * nbytes
        k["int_ops"] += m * int_ops
        k["transcendentals"] += m * transcendentals
        self.flops += m * flops
        self.bytes += m * nbytes
        self.transcendentals += m * transcendentals

    def add_accumulation(self, grads, slots: Dict[int, int]) -> None:
        """``slots[i]`` gradient additions of ``grads[i]``'s size (an
        elementwise add: read two, write one)."""
        m = self._mult[-1]
        for slot, times in slots.items():
            g = grads[slot] if slot < len(grads) else None
            if g is None:
                continue
            local = getattr(g, "_local_tensor", g)
            flops, nbytes = m * times * _numel(local), \
                m * times * 3 * _nbytes(g)
            self.flops += flops
            self.bytes += nbytes
            row = self.by_op["add"]
            row[0] += m * times
            row[1] += flops
            row[2] += nbytes

    def push_mult(self, n: float) -> None:
        self._mult.append(self._mult[-1] * n)

    def pop_mult(self) -> None:
        self._mult.pop()

    def result(self) -> dict:
        """The keys of ``hlo_cost.analyze``, and the kernels."""
        return {"flops_per_device": self.flops,
                "bytes_per_device": self.bytes,
                "ici_bytes_per_device": self.ici_bytes,
                "transcendentals": self.transcendentals,
                "collectives": {k: dict(v) for k, v in
                                self.collectives.items()},
                "unparsed_loops": 0,
                "kernels": {k: dict(v) for k, v in self.kernels.items()}}

    def table(self, top: int = 20) -> list:
        """The ops with the most flops: (name, count, flops, bytes), with
        the kernels among them; ``hlo_cost.profile_instrs``'s view."""
        rows = [(k, *v) for k, v in self.by_op.items()]
        rows += [(f"kernel:{k}", v["count"], v["flops"], v["bytes"])
                 for k, v in self.kernels.items()]
        return sorted(rows, key=lambda r: -r[2])[:top]


class _Collectives(TorchDispatchMode):
    """Inside a DTensor op: lets DTensor run (its ops on the local shards)
    and counts the collectives it issues to redistribute the operands."""

    def __init__(self, counter: OpCounter):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **(kwargs or {}))
        dt = _dtensor_type()
        if dt is not None and any(issubclass(t, dt) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if "c10d" in func.namespace:
            self.counter._count_collective(_name(func), args, out)
        return out


def _dtensor_type():
    """DTensor's class once ``torch.distributed.tensor`` is imported (it
    is, whenever a DTensor exists), else None."""
    import sys
    mod = sys.modules.get("torch.distributed.tensor")
    return getattr(mod, "DTensor", None) if mod is not None else None


def _split_of(out, dt) -> int:
    """Devices that share a DTensor op's work: the product of the mesh
    dimensions over which its first tensor result is not replicated."""
    for t in _tensors(out):
        if isinstance(t, dt):
            mesh = t.device_mesh
            return math.prod(mesh.size(i) for i, p in enumerate(t.placements)
                             if not p.is_replicate())
    return 1


# ---------------------------------------------------------------------------
# the API the kernels and the model use
# ---------------------------------------------------------------------------

def report(name: str, flops: float, nbytes: float,
           transcendentals: float = 0.0, int_ops: float = 0.0) -> None:
    """A kernel launch's cost, from the formula beside the kernel, to the
    counter in use; without one, to ``common.trace``'s tally while a
    profiler records (``trace.kernel_tally``), and nowhere otherwise."""
    if _ACTIVE:
        _ACTIVE[-1].add_kernel(name, flops, nbytes, transcendentals, int_ops)
    elif trace.recording():
        trace.tally_kernel(name, flops, nbytes, transcendentals, int_ops)


def folding(tree) -> bool:
    """Whether a loop over ``tree``'s tensors is counted from two steps
    (``fold``): under a counter, when they are on the ``meta`` device."""
    return bool(_ACTIVE) and any(t.device.type == "meta"
                                 for t in _tensors(tree))


def _marker() -> int:
    """The sequence number of an autograd node created now (a view's: the
    counter counts no cost for it)."""
    with torch.enable_grad():
        t = torch.empty((), device="meta", requires_grad=True)
        return t.view(()).grad_fn._sequence_nr()


def fold(step: Callable, carry, per_step: Callable, n: int, dim: int):
    """``n`` steps ``carry, out = step(carry, per_step(t))`` counted from
    two: step 0 runs as it is, and step 1, whose carry comes from a step
    as the later steps' do, runs with every count multiplied by n - 1, and
    so does the backward of the autograd nodes it created (hooks on them).
    Returns (the carry after those steps, their outs stacked n times along
    ``dim``): the shapes and dtypes of the unrolled loop's, for meta
    tensors, whose values nobody reads. The gradient additions that the
    unrolled loop makes and the two steps do not are counted where the
    gradient arrives (``_hook_fold``)."""
    if n <= 2:
        outs = []
        for t in range(n):
            carry, out = step(carry, per_step(t))
            outs.append(out)
        return carry, torch.stack(outs, dim=dim)
    counter = _ACTIVE[-1]
    # a recompute of non-reentrant checkpointing runs inside the backward,
    # and autograd never runs its graph: no hooks there
    graded = torch.is_grad_enabled() and \
        torch._C._current_graph_task_id() == -1
    carry, out0 = step(carry, per_step(0))
    m1 = _marker() if graded else 0
    counter.push_mult(n - 1)
    try:
        carry, out1 = step(carry, per_step(1))
    finally:
        counter.pop_mult()
    if graded:
        _hook_fold(counter, _nodes_between(_tensors((carry, out1)), m1,
                                           _marker()), n - 1)
    # the later copies carry no gradient (step 1's backward is counted n -
    # 1 times already) and are one expanded view: the concatenation reads
    # and writes what stacking n outputs would
    d = dim % (out1.dim() + 1)
    rest = out1.detach().unsqueeze(d)
    rest = rest.expand(rest.shape[:d] + (n - 2,) + rest.shape[d + 1:])
    return carry, torch.cat([out0.unsqueeze(d), out1.unsqueeze(d), rest],
                            dim=d)


def _hook_fold(counter: OpCounter, nodes: list, reps: int):
    """Hooks that count a repeated step's backward ``reps`` times, and the
    gradient additions that its reps - 1 unrolled copies would make: into
    a slot that k of the step's edges reach, (reps - 1) (k - 1) more inside
    the step, and (reps - 1) k more outside it: into a tensor every step
    reads (a sliced input, a weight) and into the carry that each step
    hands the next (step 0's stands for them). They are counted when the
    gradient reaches the slot's node (a leaf's, through its tensor hook):
    a backward that stops short of a non-leaf tensor the steps read (an
    ``autograd.grad`` input) does not count that tensor's additions."""
    inside = {id(node) for node in nodes}
    edges: Dict[tuple, int] = defaultdict(int)
    targets = {}
    for node in nodes:
        for nxt, slot in node.next_functions:
            if nxt is not None:
                edges[(id(nxt), slot)] += 1
                targets[id(nxt)] = nxt
    missing: Dict[int, Dict[int, int]] = defaultdict(dict)
    for (tid, slot), k in edges.items():
        extra = (reps - 1) * (k - 1 if tid in inside else k)
        if extra:
            missing[tid][slot] = extra
    for tid, slots in missing.items():
        node = targets[tid]
        if hasattr(node, "variable"):
            # a leaf's AccumulateGrad does not run under autograd.grad:
            # its tensor's hook sees the gradient either way, once
            handle = []
            handle.append(node.variable.register_hook(
                lambda g, s=slots, h=handle: (
                    counter.add_accumulation((g,), s), h[0].remove())
                and None))
        else:
            node.register_prehook(
                lambda grads, s=slots: counter.add_accumulation(grads, s))
    for node in nodes:
        node.register_prehook(lambda *_: counter.push_mult(reps))
        node.register_hook(lambda *_: counter.pop_mult())


def _nodes_between(outputs, first: int, last: int) -> list:
    """The autograd nodes behind ``outputs`` created between two markers."""
    seen, stack, found = set(), [t.grad_fn for t in outputs
                                 if t.grad_fn is not None], []
    while stack:
        node = stack.pop()
        if node is None or id(node) in seen:
            continue
        seen.add(id(node))
        if not first < node._sequence_nr() < last:
            continue
        found.append(node)
        stack.extend(nxt for nxt, _ in node.next_functions)
    return found


def count(fn: Callable, *args, world: int = 1, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` under an ``OpCounter`` and return its
    ``result()``."""
    with OpCounter(world) as c:
        fn(*args, **kwargs)
    return c.result()
