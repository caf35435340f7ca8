"""Per-device cost accounting for the roofline: FLOPs, HBM bytes and
collective wire bytes of one execution of a program, and its memory.

``count(fn, *args, mesh=None, **kw)`` is the port's counterpart of the
JAX package's trip-count-aware analyzer of post-SPMD HLO text: a
``TorchDispatchMode`` that applies that analyzer's accounting rules to the
aten ops ``fn`` dispatches. Eager PyTorch dispatches every iteration of a
loop, so no trip count is needed.

  * FLOPs: the products (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``,
    ``addmv``, ``dot``: whatever ``einsum``, ``linear`` and ``matmul``
    decompose to), 2 * |result| * K, as the analyzer counts ``dot``;
  * bytes: HBM traffic under the analyzer's model of fusion: only the
    materializing ops of ``_TRAFFIC`` below count, each by its rule;
    elementwise ops, views, ``expand`` and reshapes count nothing
    (fusable);
  * collectives: what ``models.sharding`` counted in ``mesh.stats`` over
    the call (its bytes follow the analyzer's ring formulas), under the
    analyzer's names, with the calls beside them;
  * memory per device, the fields of XLA's ``memory_analysis``
    (``MemoryCounts``): the inputs' storages, the outputs', the peak of
    the live storages the call created (outputs left out), and the
    outputs that are inputs updated in place.

Meta tensors need no memory and no device, so a production mesh counts on
a fake process group.
"""

from __future__ import annotations

import dataclasses
import itertools
import weakref
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


@dataclasses.dataclass
class CostSummary:
    flops: float                      # per-device, one execution
    bytes_accessed: float             # per-device
    collective_wire_bytes: Dict[str, float]  # per-device by kind
    #: per-device calls by kind
    collective_calls: Dict[str, int] = dataclasses.field(
        default_factory=dict)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_wire_bytes.values())


_aten = torch.ops.aten

#: the products, by the position of their left operand: 2 * |result| * K,
#: K the left operand's last dimension (the analyzer's ``dot``)
_PRODUCTS = {_aten.mm: 0, _aten.bmm: 0, _aten.addmm: 1, _aten.baddbmm: 1,
             _aten.mv: 0, _aten.addmv: 1, _aten.dot: 0}

#: How each materializing op moves HBM bytes (the analyzer's model);
#: every op not named here is fusable and moves none.
#:   "operands": result bytes written + operand bytes read (products,
#:       casts, concatenation, padding, reductions, sorts);
#:   "transpose": the same, where the operand is a non-contiguous view
#:       (``clone``: a layout change; a contiguous clone is a copy XLA
#:       never makes);
#:   "gather": twice the selected rows (the result), not the table;
#:   ("update", i): twice the update, operand ``i`` (scatters, in-place
#:       slice writes, ``copy_`` into a view): one slice, not the whole;
#:   "fill": the result written (random fills).
_TRAFFIC = {
    **dict.fromkeys(_PRODUCTS, "operands"),
    **dict.fromkeys((
        _aten._to_copy, _aten.cat, _aten.stack, _aten.constant_pad_nd,
        _aten.sum, _aten.mean, _aten.amax, _aten.amin, _aten.max,
        _aten.min, _aten.argmax, _aten.argmin, _aten.prod, _aten.var,
        _aten.var_mean, _aten.std, _aten.std_mean, _aten.logsumexp,
        _aten.any, _aten.all, _aten.linalg_vector_norm, _aten.norm,
        _aten._softmax, _aten._log_softmax, _aten._softmax_backward_data,
        _aten._log_softmax_backward_data, _aten.cumsum, _aten.cumprod,
        _aten.sort, _aten.topk), "operands"),
    _aten.clone: "transpose",
    **dict.fromkeys((_aten.index, _aten._unsafe_index, _aten.index_select,
                     _aten.gather, _aten.embedding), "gather"),
    **{op: ("update", i) for i, ops in (
        (0, (_aten.embedding_dense_backward,)),
        (1, (_aten.copy_, _aten.slice_scatter, _aten.select_scatter)),
        (2, (_aten.index_put, _aten.index_put_, _aten._index_put_impl_,
             _aten.masked_scatter, _aten.masked_scatter_)),
        (3, (_aten.scatter, _aten.scatter_, _aten.scatter_add,
             _aten.scatter_add_, _aten.scatter_reduce,
             _aten.scatter_reduce_, _aten.index_add, _aten.index_add_,
             _aten.index_copy, _aten.index_copy_))) for op in ops},
    **dict.fromkeys((_aten.uniform_, _aten.normal_, _aten.bernoulli_,
                     _aten.random_, _aten.exponential_, _aten.normal,
                     _aten.bernoulli, _aten.rand, _aten.randn,
                     _aten.randint, _aten.randperm), "fill"),
}

#: ``models.sharding``'s collective kinds under the analyzer's names
_KIND_NAMES = {"all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
               "all_reduce": "all-reduce", "all_to_all": "all-to-all"}


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _storages(tree) -> Dict[int, int]:
    """{storage key: bytes} of the distinct storages under ``tree``."""
    out = {}
    for t in _tensors(tree):
        s = t.untyped_storage()
        out[s._cdata] = s.nbytes()
    return out


def _aten_traffic(func, args, out) -> float:
    """HBM bytes of one dispatched aten op under ``_TRAFFIC``."""
    rule = _TRAFFIC.get(func._overloadpacket)
    if rule is None:
        return 0.0
    if rule == "gather":
        return 2.0 * _nbytes(_tensors(out))
    if rule == "fill":
        return float(_nbytes(_tensors(out)))
    if rule == "transpose" and args[0].is_contiguous():
        return 0.0
    if rule in ("operands", "transpose"):
        return float(_nbytes(_tensors(out)) + _nbytes(_tensors(args)))
    upd = args[rule[1]] if len(args) > rule[1] else None
    if isinstance(upd, torch.Tensor):
        return 2.0 * _nbytes([upd])
    return 2.0 * _nbytes(_tensors(out))


def _aten_flops(func, args, out) -> float:
    """2 * |result| * K of a product, else 0."""
    lhs = _PRODUCTS.get(func._overloadpacket)
    if lhs is None:
        return 0.0
    return 2.0 * out.numel() * args[lhs].shape[-1]


@dataclasses.dataclass
class MemoryCounts:
    """One call's memory per device, in the fields of XLA's
    ``memory_analysis``."""
    argument_bytes: int     # the storages of every input
    output_bytes: int       # the storages of every output
    temp_bytes: int         # the peak of the live storages the call made,
                            # the outputs left out
    alias_bytes: int        # outputs that are inputs updated in place

    @property
    def peak_estimate(self) -> int:
        return (self.argument_bytes + self.output_bytes + self.temp_bytes
                - self.alias_bytes)


class _Counter(TorchDispatchMode):
    """FLOPs and bytes of every dispatched op, and the live bytes of the
    storages the ops create, freed as their storages die.

    The live storages are kept in creation order as segments of time: a
    segment starts at its storage's creation and holds the most live bytes
    seen before the next live storage's creation; a dying storage's
    segment merges into the one before it. At the end only the outputs'
    segments and the root remain beside the survivors, so the peak with
    the outputs left out is read off without a timeline."""

    def __init__(self, inputs, meta: bool = False):
        super().__init__()
        self.inputs = inputs
        #: on meta tensors: the output layouts of each functional op by
        #: its inputs' layouts and its other arguments (``_meta_call``)
        self.memo: Optional[dict] = {} if meta else None
        self.flops = 0.0
        self.bytes = 0.0
        self.live: Dict[int, int] = {}       # storage key -> segment
        self.size: Dict[int, int] = {}       # segment -> its bytes
        self.top = {0: 0}                    # segment -> most live bytes
        self.prev: Dict[int, int] = {}
        self.next: Dict[int, Optional[int]] = {0: None}
        self.fin: Dict[int, weakref.finalize] = {}
        self.last = 0
        self.now = 0
        self.ids = itertools.count(1)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.memo is None or _kind(func) is None:
            out = func(*args, **kwargs)
        else:
            out = self._meta_call(func, args, kwargs)
        self.flops += _aten_flops(func, args, out)
        self.bytes += _aten_traffic(func, args, out)
        for t in _tensors(out):
            self._made(t)
        return out

    def _meta_call(self, func, args, kwargs):
        """``func`` on meta tensors: a meta tensor's layout is a function
        of the inputs' layouts and the other arguments alone, and most
        meta kernels are Python (``torch._refs``), ~0.05-0.5 ms an op. An
        op seen before with the same key is not run again: a functional
        op gets fresh empty outputs of the layouts it gave, an in-place op
        that keeps its tensor's layout returns the tensor it writes."""
        try:
            key = (func, _layout_key(args), _layout_key(kwargs))
            hit = self.memo.get(key)
        except TypeError:        # an argument that does not hash
            return func(*args, **kwargs)
        if hit is not None:
            if hit == "self":
                return args[0]
            made = [torch.empty_strided(shape, stride, dtype=dtype,
                                        device="meta")
                    for shape, stride, dtype in hit[1]]
            return made[0] if hit[0] else tuple(made)
        out = func(*args, **kwargs)
        if _kind(func) == "inplace":
            # only where the op left its tensor's layout as it was (an
            # ``unsqueeze_`` or ``transpose_`` must run every time)
            if _layout_key(out) == key[1][0]:
                self.memo[key] = "self"
            return out
        single = isinstance(out, torch.Tensor)
        outs = [out] if single else out
        if (single or isinstance(outs, tuple)) and all(
                isinstance(t, torch.Tensor) and t.is_meta for t in outs) \
                and not set(_storages(outs)) & set(_storages((args,
                                                              kwargs))):
            # (an op such as ``_unsafe_view`` aliases with no annotation)
            self.memo[key] = (single, [(t.shape, t.stride(), t.dtype)
                                       for t in outs])
        return out

    def _made(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = s._cdata
        if key in self.live or key in self.inputs:
            return
        i = next(self.ids)
        self.live[key] = i
        self.size[i] = s.nbytes()
        self.now += self.size[i]
        self.prev[i], self.next[i] = self.last, None
        self.next[self.last] = i
        self.last = i
        self.top[i] = self.now
        self.fin[i] = weakref.finalize(s, self._freed, key, i)

    def _freed(self, key: int, i: int) -> None:
        del self.live[key], self.fin[i]
        self.now -= self.size.pop(i)
        p, n = self.prev.pop(i), self.next.pop(i)
        self.top[p] = max(self.top[p], self.top.pop(i))
        self.next[p] = n
        if n is None:
            self.last = p
        else:
            self.prev[n] = p

    def temp_bytes(self, outputs) -> int:
        """The peak of the live storages this call made, ``outputs``
        (storage keys) left out; stops the tracking."""
        mine = {self.live[k]: n for k, n in outputs.items()
                if k in self.live}
        peak, held, i = 0, 0, 0
        while i is not None:
            held += mine.get(i, 0)
            peak = max(peak, self.top[i] - held)
            i = self.next[i]
        for f in list(self.fin.values()):
            f.detach()
        return peak


_KINDS: Dict[object, Optional[str]] = {}


def _kind(func) -> Optional[str]:
    """"functional" (writes no argument, returns no alias of one),
    "inplace" (writes its first argument and returns it) or None."""
    if func in _KINDS:
        return _KINDS[func]
    schema = func._schema
    rets, params = schema.returns, schema.arguments
    kind = None
    if not schema.is_mutable and all(
            x.alias_info is None for x in (*rets, *params)):
        kind = "functional"
    elif (len(rets) == 1 and rets[0].alias_info is not None and params
          and params[0].alias_info is not None
          and params[0].alias_info.is_write
          and rets[0].alias_info.before_set == params[0].alias_info.before_set
          and all(a.alias_info is None for a in params[1:])):
        kind = "inplace"
    _KINDS[func] = kind
    return kind


def _layout_key(tree):
    """A hashable key of ``tree``'s tensors' layouts and its other
    values; raises TypeError on a tensor that is not on meta."""
    if isinstance(tree, torch.Tensor):
        if not tree.is_meta:
            raise TypeError("not a meta tensor")
        return (tree.shape, tree.stride(), tree.dtype)
    if isinstance(tree, (list, tuple)):
        return tuple(_layout_key(v) for v in tree)
    if isinstance(tree, dict):
        return tuple((k, _layout_key(v)) for k, v in tree.items())
    hash(tree)
    # the type too: 2 == 2.0 == True, but they promote an integer tensor
    # to different dtypes
    return type(tree), tree


def _collectives(mesh, before) -> Tuple[Dict[str, float], Dict[str, int]]:
    if mesh is None:
        return {}, {}
    wire, calls = {}, {}
    for k, name in _KIND_NAMES.items():
        n = mesh.stats.calls[k] - before[0][k]
        if n:
            calls[name] = n
            wire[name] = float(mesh.stats.sent_bytes[k] - before[1][k])
    return wire, calls


def count(fn, *args, mesh=None, **kw):
    """Run ``fn(*args, **kw)`` and count it: returns (its result, a
    ``CostSummary`` per device, its ``MemoryCounts``). ``mesh``: the
    ``models.sharding.Mesh`` whose collectives the call runs. Every tensor
    ``fn`` reads but its arguments' must be made inside it (a tensor it
    closes over counts as made by it only where an op makes it)."""
    inputs = _storages((args, kw))
    before = None if mesh is None else (dict(mesh.stats.calls),
                                        dict(mesh.stats.sent_bytes))
    mode = _Counter(inputs, meta=all(
        t.is_meta for t in _tensors((args, kw))))
    with mode:
        result = fn(*args, **kw)
    outs = _storages(result)
    mem = MemoryCounts(
        argument_bytes=sum(inputs.values()),
        output_bytes=sum(outs.values()),
        temp_bytes=mode.temp_bytes(outs),
        alias_bytes=sum(n for k, n in outs.items() if k in inputs))
    wire, calls = _collectives(mesh, before)
    return result, CostSummary(mode.flops, mode.bytes, wire, calls), mem
