"""What a step costs, counted as it runs: the port's counterpart of
``repro.launch.hlo_cost``.

The reference lowers and compiles a step on forced host devices and reads
the FLOPs, bytes and collectives off the partitioned HLO text.  The port
runs its own step function once under ``count()``, a
``TorchDispatchMode``, usually on fake tensors (``FakeTensorMode``) over a
fake process group, so nothing is allocated on any device.  It counts,
per rank:

  * FLOPs       -- the matmuls (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
                   forward and backward alike) by ``torch.utils.
                   flop_counter``'s formulas, plus each kernel call's work
                   by its rule (below);
  * HBM bytes   -- every op's tensor operands and outputs, views and
                   metadata ops skipped (``SKIP_BYTES_OPS``), a gather the
                   bytes of its result twice and an indexed update those
                   of its update twice, as ``hlo_cost`` counts them: an
                   upper bound, like the reference's ``hlo_bytes_upper``
                   (an eager step fuses nothing, so here it is also close
                   to what the card moves);
  * collectives -- every ``c10d`` op the step issues, under the
                   reference's op names, with ``hlo_cost._collective_cost``'s
                   ring-model wire bytes; the group size is that of the
                   op's process group;
  * kernels     -- each call of a ``kernels.ops`` wrapper, which hands it
                   to the counter (``ops.COUNTER``) in the counting thread
                   (a call on real card tensors alone is refused): its launches and the
                   work the Hopper kernel does, by the rules beside the
                   kernels (``flash_attention.fwd_work`` / ``bwd_work``,
                   ``paged_attention.paged_work``, ``ssd_scan.ssd_work`` /
                   ``ssd_bwd_work``, ``pwl_softmax.softmax_work``,
                   ``cim_matmul.cim_work``).  The call returns the plain
                   version's outputs (empty ones of the same shapes on fake
                   tensors) with the counter paused, so the plain
                   version's arithmetic is not counted.  Under grad a
                   flash or SSD call goes through a function whose backward
                   counts the backward kernel, once per backward, as the
                   card launches it (remat recomputes the forward);
  * peak bytes  -- the largest sum of the storages that the step's ops
                   made and that were alive at once (the counterpart of
                   XLA's ``temp_size_in_bytes``).

A paged call keeps the keys ``[ctx - window, ctx)`` below its table's
capacity; on fake tensors ``ctx`` is known only where ``torch.full`` made
the lengths (a decode step's int ``cache_len``), and is otherwise taken as
the whole table.
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels import ops
from repro_torch.kernels.cim_matmul import cim_matmul_plain, cim_work
from repro_torch.kernels.flash_attention import (bwd_work, flash_attention_bwd_plain,
                                                 flash_attention_plain, fwd_work)
from repro_torch.kernels.paged_attention import paged_attention_plain, paged_work
from repro_torch.kernels.pwl_softmax import pwl_softmax_plain, softmax_work
from repro_torch.kernels.ssd_scan import (ssd_bwd_work, ssd_scan_bwd_plain, ssd_scan_plain,
                                          ssd_work)

aten = torch.ops.aten

SKIP_BYTES_OPS = {
    aten.empty, aten.empty_strided, aten.new_empty, aten.new_empty_strided, aten.detach,
    aten.lift_fresh, aten.lift_fresh_copy, aten._local_scalar_dense, aten.alias,
    aten._unsafe_view,
    aten.sym_size, aten.sym_stride, aten.sym_numel, aten.sym_storage_offset, aten.set_,
}
# reads only the elements of its result (an embedding row, a gathered index)
GATHER_OPS = {aten.index_select, aten.embedding, aten.gather, aten.index, aten.take}
# writes its update into a buffer in place: (position of the update in the args)
UPDATE_OPS = {aten.copy_: 1, aten.index_copy_: 3, aten.index_copy: 3, aten.index_put_: 2,
              aten.index_put: 2, aten.scatter_: 3, aten.scatter_add_: 3, aten.index_add_: 3,
              aten.slice_scatter: 1, aten.select_scatter: 1}
MATMUL_OPS = (aten.mm, aten.addmm, aten.bmm, aten.baddbmm)
# c10d op -> the reference's collective
COLLECTIVES = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
}
NO_DATA_C10D = {"barrier", "monitored_barrier_"}


@dataclass
class Cost:
    """The reference's ``hlo_cost.Cost`` (``flops``, ``bytes``, ``coll[op]
    = {count, bytes, wire_bytes}``) with the kernels' share,
    ``kernels[name] = {launches, flops, bytes}`` (included in ``flops`` and
    ``bytes``), and the peak live bytes."""
    flops: float = 0.0
    bytes: float = 0.0
    coll: Dict[str, Dict[str, float]] = field(default_factory=dict)
    kernels: Dict[str, Dict[str, float]] = field(default_factory=dict)
    peak_bytes: float = 0.0
    flop_counter: float = 0.0

    def add_coll(self, op: str, logical: float, wire: float, count: float):
        d = self.coll.setdefault(op, {"count": 0.0, "bytes": 0.0,
                                      "wire_bytes": 0.0})
        d["count"] += count
        d["bytes"] += logical
        d["wire_bytes"] += wire

    def add_kernel(self, name: str, nbytes: float, flops: float, launches: float = 1):
        d = self.kernels.setdefault(name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
        d["launches"] += launches
        d["flops"] += flops
        d["bytes"] += nbytes
        self.flops += flops
        self.bytes += nbytes

    def scaled(self, k: float) -> "Cost":
        c = Cost(self.flops * k, self.bytes * k, peak_bytes=self.peak_bytes)
        for op, d in self.coll.items():
            c.coll[op] = {kk: v * k for kk, v in d.items()}
        for name, d in self.kernels.items():
            c.kernels[name] = {kk: v * k for kk, v in d.items()}
        return c

    def merge(self, other: "Cost"):
        self.flops += other.flops
        self.bytes += other.bytes
        for op, d in other.coll.items():
            self.add_coll(op, d["bytes"], d["wire_bytes"], d["count"])
        for name, d in other.kernels.items():
            k = self.kernels.setdefault(name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
            for kk, v in d.items():
                k[kk] += v
        self.peak_bytes = max(self.peak_bytes, other.peak_bytes)

    @property
    def wire_bytes(self) -> float:
        return sum(d["wire_bytes"] for d in self.coll.values())

    @property
    def kernel_flops(self) -> float:
        return sum(d["flops"] for d in self.kernels.values())

    @property
    def launches(self) -> Dict[str, int]:
        return {name: int(d["launches"]) for name, d in self.kernels.items()}


def ring_wire(op: str, out_bytes: float, g: int):
    """(logical bytes, wire bytes) of one collective of ``g`` ranks whose
    output holds ``out_bytes`` a rank: ``hlo_cost._collective_cost``'s ring
    rules."""
    g = max(g, 1)
    ring = (g - 1) / g
    if op == "all-gather":
        return out_bytes, out_bytes * ring
    if op == "all-reduce":
        return out_bytes, 2 * out_bytes * ring
    if op == "reduce-scatter":
        return out_bytes * g, out_bytes * g * ring
    if op == "all-to-all":
        return out_bytes, out_bytes * ring
    if op == "collective-permute":
        return out_bytes, out_bytes
    raise ValueError(f"no ring rule for {op!r}")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def tree_bytes(x) -> int:
    """The bytes of the tensors in ``x`` (nested lists, tuples, dicts)."""
    return sum(map(_nbytes, _tensors(x)))


def _tensors(x):
    """The tensors in ``x``, nested in lists, tuples and dicts."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


class _Counter(TorchDispatchMode):
    def __init__(self, cost: Cost):
        super().__init__()
        self.cost = cost
        self.paused = False
        self.live = 0
        self.refs: Dict[int, list] = {}       # storage -> [bytes, tensors alive]
        self.known = WeakIdKeyDictionary()    # int tensor made by full -> its value

    @contextlib.contextmanager
    def pause(self):
        was, self.paused = self.paused, True
        try:
            yield
        finally:
            self.paused = was

    # ---- peak live bytes ------------------------------------------------
    def track(self, out, inputs=()):
        """Count the storages of ``out`` that are new; a view or an in-place
        result of an input whose storage the step did not make is not."""
        owned = {t.untyped_storage()._cdata for t in _tensors(inputs)}
        for t in _tensors(out):
            if getattr(t, "_cost_seen", None) is self:
                continue
            st = t.untyped_storage()
            key = st._cdata
            ref = self.refs.get(key)
            if ref is None:
                if key in owned:
                    continue
                ref = self.refs[key] = [st.nbytes(), 0]
                self.live += ref[0]
                self.cost.peak_bytes = max(self.cost.peak_bytes, self.live)
            t._cost_seen = self
            ref[1] += 1
            weakref.finalize(t, self._release, key)

    def _release(self, key):
        ref = self.refs.get(key)
        if ref is None:
            return
        ref[1] -= 1
        if ref[1] == 0:
            self.live -= ref[0]
            del self.refs[key]

    # ---- ops ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.paused:
            return out
        if func.namespace == "c10d":
            self._collective(func, args, kwargs)
            return out
        outs = list(_tensors(out))
        if func.namespace == "prim" or not outs:        # metadata: prim.device, sizes
            return out
        packet = func.overloadpacket
        if packet is aten.full and not out.is_floating_point():
            self.known[out] = int(args[1])
        if packet in MATMUL_OPS:
            self.cost.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if packet in SKIP_BYTES_OPS or func.is_view:
            pass
        elif packet in GATHER_OPS:
            self.cost.bytes += 2 * tree_bytes(outs)
        elif packet in UPDATE_OPS:
            i = UPDATE_OPS[packet]
            upd = args[i] if len(args) > i else kwargs.get("src", kwargs.get("values"))
            self.cost.bytes += 2 * tree_bytes(upd)
        else:
            self.cost.bytes += tree_bytes((args, kwargs)) + tree_bytes(outs)
        self.track(outs, (args, kwargs))
        return out

    def _collective(self, func, args, kwargs):
        name = func._schema.name.split("::")[-1]
        if name in NO_DATA_C10D:
            return
        op = COLLECTIVES.get(name)
        if op is None:
            raise NotImplementedError(f"launch.cost: no rule for the collective {func}")
        bound = dict(zip((a.name for a in func._schema.arguments), args), **kwargs)
        g = torch.distributed.ProcessGroup.unbox(bound["process_group"]).size()
        dst = next(bound[a] for a in ("output_tensors", "output_tensor", "output", "tensors")
                   if a in bound)
        out_b = tree_bytes(dst)
        logical, wire = ring_wire(op, out_b, g)
        self.cost.add_coll(op, logical, wire, 1)
        self.cost.bytes += out_b

    # ---- kernels (``ops.COUNTER``) -------------------------------------------
    def kernel(self, name, *args, **kw):
        """One call of the ``kernels.ops`` wrapper ``name``, counted.  The
        counter runs no kernel: a call with no fake tensor is refused unless
        all its tensors lie on the CPU.  A real tensor beside fake ones (a
        constant kept from before the count, such as a cached block table)
        is only read for its shape or values."""
        tensors = list(_tensors((args, kw)))
        if not any(map(is_fake, tensors)):
            for t in tensors:
                if t.device.type != "cpu":
                    raise RuntimeError(f"launch.cost: {name} is counted on fake or CPU "
                                       f"tensors, not on a {t.device} tensor")
        return getattr(self, "_" + name)(*args, **kw)

    def _run(self, fake_outputs, plain, *inputs):
        """The kernel's outputs: empty ones on fake tensors, the plain
        version's on real CPU ones, with the counter paused; then tracked."""
        with self.pause(), torch.no_grad():
            out = fake_outputs() if any(is_fake(t) for t in inputs) else plain()
        self.track(out)
        return out

    def _flash_attention(self, q, k, v, **kw):
        b, sq, hq, d = q.shape
        skv, hkv = k.shape[1], k.shape[2]
        grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
        mask = (kw["causal"], kw["window"], kw["prefix_len"], kw["q_offset"])
        self.cost.add_kernel("flash_attention",
                             *fwd_work(b, sq, skv, hq, hkv, d, q.element_size(), *mask, lse=grad))
        if grad:
            return _CountedFlash.apply(q, k, v, self, kw)
        return self._run(lambda: torch.empty_like(q),
                         lambda: flash_attention_plain(q, k, v, **kw), q, k, v)

    def _paged(self, q, k_cache, block_tables, context_lens, window, key_offset, partial):
        cap = block_tables.shape[1] * k_cache.shape[1]
        if not is_fake(context_lens):
            lens = context_lens.tolist()
        elif context_lens in self.known:
            lens = [self.known[context_lens]] * q.shape[0]
        else:
            lens = [cap + key_offset] * q.shape[0]
        kept = 0
        for c in lens:
            hi = min(max(c - key_offset, 0), cap)
            lo = max(c - window - key_offset, 0) if window else 0
            kept += max(hi - lo, 0)
        self.cost.add_kernel("paged_attention",
                             *paged_work(q, k_cache, block_tables, kept, partial=partial))

    def _paged_attention(self, q, k_cache, v_cache, block_tables, context_lens, **kw):
        self._paged(q, k_cache, block_tables, context_lens, kw["window"], 0, False)
        return self._run(lambda: torch.empty_like(q), lambda: paged_attention_plain(
            q, k_cache, v_cache, block_tables, context_lens, **kw), q, k_cache)

    def _paged_attention_partial(self, q, k_cache, v_cache, block_tables, context_lens, **kw):
        self._paged(q, k_cache, block_tables, context_lens, kw["window"], kw["key_offset"],
                    True)
        B, H, D = q.shape

        def fake():
            f32 = dict(dtype=torch.float32, device=q.device)
            return torch.empty((B, H, D), **f32), torch.empty((B, H), **f32), \
                torch.empty((B, H), **f32)
        return self._run(fake, lambda: paged_attention_plain(
            q, k_cache, v_cache, block_tables, context_lens, partial=True, **kw), q, k_cache)

    def _ssd_scan(self, x, dt, a_neg, B, C, *, chunk):
        b, s, h, p = x.shape
        self.cost.add_kernel("ssd_scan", *ssd_work(b, s, h, p, B.shape[-1], x.element_size()))
        if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, a_neg, B, C)):
            return _CountedSSD.apply(x, dt, a_neg, B, C, self, chunk)
        return self._run(lambda: _ssd_empty(x, B),
                         lambda: ssd_scan_plain(x, dt, a_neg, B, C, chunk), x, B)

    def _pwl_softmax(self, x):
        self.cost.add_kernel("pwl_softmax", *softmax_work(x))
        return self._run(lambda: torch.empty_like(x), lambda: pwl_softmax_plain(x), x)

    def _cim_matmul_quantized(self, x, wq, wscale, *, wqt, **kw):
        nbytes, int8_ops, f32_ops = cim_work(x, wq, wscale)
        self.cost.add_kernel("cim_matmul", nbytes, int8_ops + f32_ops)
        M, N = x.shape[0], wq.shape[1]
        return self._run(lambda: torch.empty((M, N), dtype=torch.float32, device=x.device),
                         lambda: cim_matmul_plain(x, wq, wscale, **kw), x, wq)


def _ssd_empty(x, B):
    b, s, h, p = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    return torch.empty((b, s, h, p), **f32), torch.empty((b, h, p, B.shape[-1]), **f32)


class _CountedFlash(torch.autograd.Function):
    """A counted flash call under grad: the forward's outputs as
    ``_Counter._run`` gives them, the backward counted by ``bwd_work``."""

    @staticmethod
    def forward(ctx, q, k, v, counter, kw):
        ctx.counter, ctx.kw = counter, kw
        out = counter._run(lambda: (torch.empty_like(q), None),
                           lambda: flash_attention_plain(q, k, v, return_lse=True, **kw),
                           q, k, v)
        ctx.save_for_backward(q, k, v, out[0], *([] if out[1] is None else [out[1]]))
        return out[0]

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, *lse = ctx.saved_tensors
        kw, counter = ctx.kw, ctx.counter
        b, sq, hq, d = q.shape
        counter.cost.add_kernel("flash_attention_bwd", *bwd_work(
            b, sq, k.shape[1], hq, k.shape[2], d, q.element_size(), kw["causal"], kw["window"],
            kw["prefix_len"], kw["q_offset"]))
        grads = counter._run(
            lambda: tuple(torch.empty_like(t) for t in (q, k, v)),
            lambda: flash_attention_bwd_plain(q, k, v, out, lse[0], dout, causal=kw["causal"],
                                              window=kw["window"], prefix_len=kw["prefix_len"],
                                              q_offset=kw["q_offset"]), q, dout)
        return (*grads, None, None)


class _CountedSSD(torch.autograd.Function):
    """A counted SSD scan under grad: the backward counted by
    ``ssd_bwd_work``, with the final state's gradient where one arrives."""

    @staticmethod
    def forward(ctx, x, dt, a_neg, B, C, counter, chunk):
        ctx.counter, ctx.chunk = counter, chunk
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a_neg, B, C)
        return counter._run(lambda: _ssd_empty(x, B),
                            lambda: ssd_scan_plain(x, dt, a_neg, B, C, chunk), x, B)

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, a_neg, B, C = ctx.saved_tensors
        counter = ctx.counter
        b, s, h, p = x.shape
        counter.cost.add_kernel("ssd_scan_bwd", *ssd_bwd_work(
            b, s, h, p, B.shape[-1], x.element_size(), dstate is not None))

        def plain():
            y_grad = torch.zeros((b, s, h, p), dtype=torch.float32) if dy is None else dy
            return ssd_scan_bwd_plain(x, dt, a_neg, B, C, y_grad, dstate, ctx.chunk)
        grads = counter._run(lambda: tuple(torch.empty_like(t) for t in (x, dt, a_neg, B, C)),
                             plain, x, B)
        return (*grads, None, None)


@contextlib.contextmanager
def count():
    """Count what runs inside: yields the ``Cost``, filled as the block
    runs.  Enter it inside the ``FakeTensorMode`` of fake inputs (``analyze``
    does).  Not re-entrant.  It counts in the thread that enters it (and in
    autograd's threads for a backward run from there); a kernel wrapper
    called in any other thread meanwhile takes its own route, uncounted."""
    if ops.COUNTER is not None:
        raise RuntimeError("launch.cost.count is already counting")
    cost = Cost()
    counter = _Counter(cost)
    ops.COUNTER = counter
    try:
        with counter:
            yield cost
    finally:
        ops.COUNTER = None


@contextlib.contextmanager
def fake_context(*args):
    """The ``FakeTensorMode`` of the fake tensors among ``args`` (nested
    trees of dicts, lists and tuples), entered unless it is active; nothing
    for real tensors."""
    from torch._guards import detect_fake_mode
    mode = detect_fake_mode(list(_tensors(args)))
    with contextlib.ExitStack() as st:
        if mode is not None and detect_fake_mode() is None:
            st.enter_context(mode)
        yield mode


def run_counted(fn, *args, **kwargs):
    """(``fn(*args, **kwargs)``, its ``Cost``): one run under the counter,
    in the fake mode of its fake inputs; ``Cost.flop_counter`` is
    ``FlopCounterMode``'s own total of the same run."""
    with fake_context(args, kwargs), FlopCounterMode(display=False) as fc, count() as cost:
        out = fn(*args, **kwargs)
    cost.flop_counter = fc.get_total_flops()
    return out, cost


def analyze(fn, *args, **kwargs) -> Cost:
    """The ``Cost`` of one run of ``fn(*args, **kwargs)`` (``run_counted``)."""
    return run_counted(fn, *args, **kwargs)[1]
