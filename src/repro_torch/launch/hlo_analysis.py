"""Traced cost counts of one call and the three-term roofline.

The port of :mod:`repro.launch.hlo_analysis`.  The reference reads XLA's
compiled module: it parses the post-SPMD HLO for collective operand
bytes and walks it with loop trip counts for dot FLOPs and bytes.
Eager PyTorch has no compiled module to read, so the port counts while
the call runs, in one ``TorchDispatchMode`` (:class:`Tally`) that sees
every ATen op, forward, backward and recomputed alike:

* FLOPs: ``torch.utils.flop_counter``'s formulas (``flop_registry``,
  with ``FlopCounterMode``'s rule of decomposing an op it has no formula
  for), so the count equals ``FlopCounterMode``'s.
* bytes: the reference's bytes model (every top-level instruction reads
  its operands and writes its result once).  In eager PyTorch every op
  is top level, so this is the eager program's traffic: every operand
  and result of every op that is not a view.
* collective bytes: the operand bytes that each ``c10d`` /
  ``_c10d_functional`` all-gather, all-reduce, reduce-scatter and
  all-to-all hands to the transport, by kind, with counts (the
  reference's convention).
* live bytes: each storage an op allocates counts from its allocation
  until it is freed, on top of the call's arguments; the peak is the
  most live at once.

On DTensors (the partitioned step) the counter lets DTensor dispatch
first (it returns ``NotImplemented`` for an op on DTensors, as
``CommDebugMode`` does) and counts what DTensor then runs: each rank's
local operations on its shards, and the ``_c10d_functional``
collectives of its redistributions, each once (its ``wait_tensor``
moves nothing).  The arguments and results count by their local shards.
The shape inference of DTensor's sharding propagation, which runs the
op on global shapes under a ``FakeTensorMode``, is not counted.

The CUDA kernels of the port are one opaque op to the counter on the
card, as a Pallas call is to the reference's dot count: their FLOPs and
bytes are not seen.  On the CPU and the meta device their wrappers run
the plain versions, which are counted.

:func:`trip_range` is the counterpart of the reference's trip-count
multiply: under a :class:`Tally` it runs the first iteration of a loop
once and the second in place of the rest, counted ``n - 1`` times.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict, Iterator, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_KINDS = {"allreduce_": "all-reduce", "all_reduce": "all-reduce",
          "all_reduce_coalesced": "all-reduce",
          "allgather_": "all-gather", "_allgather_base_": "all-gather",
          "allgather_into_tensor_coalesced_": "all-gather",
          "all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_coalesced": "all-gather",
          "reduce_scatter_": "reduce-scatter",
          "_reduce_scatter_base_": "reduce-scatter",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
          "all_to_all_single": "all-to-all"}
# the argument that carries the data handed to the transport
_OPERANDS = ("tensors", "input_tensors", "input_tensor", "input", "inputs")
# shape queries FlopCounterMode passes over
_QUERIES = {"sym_is_contiguous", "is_contiguous", "is_strides_like_format",
            "is_non_overlapping_and_dense", "size", "sym_size", "stride",
            "sym_stride", "storage_offset", "sym_storage_offset", "numel",
            "sym_numel", "dim", "layout"}


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int]
    count_by_kind: Dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def describe(self) -> str:
        parts = [f"{k}: n={self.count_by_kind[k]} "
                 f"{self.bytes_by_kind[k]/1e9:.3f}GB"
                 for k in sorted(self.bytes_by_kind)]
        return "; ".join(parts) if parts else "none"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x) -> List[torch.Tensor]:
    """The tensors in ``x`` (nested tuples, lists and dicts), in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _collective(func) -> Tuple[str, str]:
    """(kind, operand argument name) of a collective op, else ``("", "")``."""
    ns = func.namespace
    if ns not in ("c10d", "_c10d_functional"):
        return "", ""
    kind = _KINDS.get(func._overloadpacket.__name__, "")
    if not kind:
        return "", ""
    names = [a.name for a in func._schema.arguments]
    return kind, next((n for n in _OPERANDS if n in names), names[0])


# a functional collective's handles, which move no data
_BOOKKEEPING = {"wait_tensor", "_wrap_tensor_autograd"}


def _in_fake_mode() -> bool:
    """Whether a ``FakeTensorMode`` is on the dispatch stack: DTensor's
    sharding propagation infers an op's global output shape under one."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    return any(isinstance(m, FakeTensorMode)
               for m in _get_current_dispatch_mode_stack())


def _locals(x) -> List[torch.Tensor]:
    """The tensors in ``x``, each DTensor as its local shard."""
    return [getattr(t, "_local_tensor", t) for t in _tensors(x)]


_ACTIVE: List["Tally"] = []
_DECOMPOSES: Dict[Any, bool] = {}


def _decomposes(func) -> bool:
    """Whether ``func`` has a CompositeImplicitAutograd kernel (the ops
    ``FlopCounterMode`` decomposes), memoized."""
    has = _DECOMPOSES.get(func)
    if has is None:
        has = _DECOMPOSES[func] = torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)
    return has


class Tally(TorchDispatchMode):
    """Counts FLOPs, bytes, collectives and live bytes of the ops run
    inside it (use :meth:`run`).  ``trips=False`` makes
    :func:`trip_range` a plain ``range`` (a full trace)."""

    def __init__(self, trips: bool = True) -> None:
        super().__init__()
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        self._formulas = flop_registry
        self._dtensor = DTensor
        self.trips = trips
        self.scale = 1
        self.flops = 0.0
        self.bytes = 0.0
        self.coll_bytes: Dict[str, float] = {}
        self.coll_counts: Dict[str, int] = {}
        self.coll_static = 0.0           # each collective counted once
        self.ops = 0
        self.live = 0
        self.peak = 0
        self.argument_bytes = 0
        self.output_bytes = 0
        self._storages: Dict[int, int] = {}
        self._open = True

    # ---- live storages -------------------------------------------------

    def _hold(self, t: torch.Tensor) -> int:
        """Counts ``t``'s storage live until it is freed; returns its bytes
        if it was not counted yet, else 0."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return 0
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        weakref.finalize(st, self._free, key)
        return n

    def _free(self, key: int) -> None:
        if self._open:
            self.live -= self._storages.pop(key, 0)

    # ---- dispatch ------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        packet = func._overloadpacket
        if packet.__name__ in _QUERIES or \
                func is torch.ops.prim.device.default or _in_fake_mode():
            return func(*args, **kwargs)
        if func.namespace == "_c10d_functional" and \
                packet.__name__ in _BOOKKEEPING:
            return func(*args, **kwargs)
        if packet not in self._formulas and _decomposes(func):
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        s = self.scale
        self.ops += 1
        if packet in self._formulas:
            self.flops += s * self._formulas[packet](*args, **kwargs,
                                                     out_val=out)
        kind, operand = _collective(func)
        if kind:
            arg = dict(zip((a.name for a in func._schema.arguments),
                           args)).get(operand, kwargs.get(operand))
            n = sum(_nbytes(t) for t in _tensors(arg))
            self.coll_bytes[kind] = self.coll_bytes.get(kind, 0) + s * n
            self.coll_counts[kind] = self.coll_counts.get(kind, 0) + s
            self.coll_static += n
        if not func.is_view:
            self.bytes += s * sum(_nbytes(t) for t in _tensors(
                (args, kwargs, out)))
            # a view's storage is its base's (on meta, ``split``'s views
            # come back with storages of their own)
            for t in _tensors(out):
                self._hold(t)
        self.peak = max(self.peak, self.live)
        return out

    def run(self, fn: Callable, *args, **kwargs) -> Any:
        """``fn(*args, **kwargs)`` counted; the arguments' storages are
        live from the start.  ``output_bytes`` are the result's storages
        that are not the arguments'."""
        args_in = _locals((args, kwargs))
        for t in args_in:
            self.argument_bytes += self._hold(t)
        self.peak = self.live
        _ACTIVE.append(self)
        try:
            with self:
                out = fn(*args, **kwargs)
        finally:
            _ACTIVE.remove(self)
        outs = _locals(out)
        for t in outs:
            self._hold(t)
        self.peak = max(self.peak, self.live)
        mine = {t.untyped_storage()._cdata for t in outs} - \
            {t.untyped_storage()._cdata for t in args_in}
        self.output_bytes = sum(self._storages[k] for k in mine)
        self._open = False
        return out

    @property
    def collectives(self) -> CollectiveStats:
        return CollectiveStats({k: int(v) for k, v in
                                self.coll_bytes.items()},
                               dict(self.coll_counts))

    @property
    def collective_bytes(self) -> float:
        return float(sum(self.coll_bytes.values()))


def trip_range(n: int) -> Iterator[int]:
    """``range(n)``, but under a :class:`Tally` (with ``trips``) the
    first iteration runs once and the second stands for the other
    ``n - 1``, whose ops it counts ``n - 1`` times: the loop's iterations
    must do the same work at the same shapes from the second on (the
    reference's while body times its trip count)."""
    tally = _ACTIVE[-1] if _ACTIVE else None
    if tally is None or not tally.trips or n <= 2:
        yield from range(n)
        return
    yield 0
    tally.scale *= n - 1
    try:
        yield 1
    finally:
        tally.scale //= n - 1


def step_cost(fn: Callable, *args, **kwargs) -> Tuple[float, float, float]:
    """(flops, bytes, collective bytes) of one call of ``fn``, the
    counterpart of the reference's ``loop_aware_cost``; bytes as the eager
    program moves them (see the module doc)."""
    tally = Tally()
    tally.run(fn, *args, **kwargs)
    return tally.flops, tally.bytes, tally.collective_bytes


def collective_bytes(fn: Callable, *args, **kwargs) -> CollectiveStats:
    """Collective operand bytes and counts, by kind, of one call."""
    tally = Tally()
    tally.run(fn, *args, **kwargs)
    return tally.collectives


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    chips: int
    peak_flops: float
    hbm_bw: float
    link_bw: float
    model_flops: float = 0.0          # 6*N*D (or 6*N_active*D)

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / self.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / self.link_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the chip's peak the step would achieve if it runs
        exactly at the dominant-term bound: useful FLOPs / (bound_s * chips
        * peak)."""
        denom = self.bound_s * self.chips * self.peak_flops
        return self.model_flops / denom if denom else 0.0

    def row(self) -> Dict[str, float]:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "hlo_flops_global": self.flops_per_device * self.chips,
            "useful_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }
