"""Dispatch of the port's kernels.

A CPU tensor goes to the kernel's plain PyTorch version; a CUDA tensor
goes to the hand-written Hopper kernel, or the call raises.  There is no
fallback from one to the other.  ``LAUNCHES`` counts the kernel launches
of each wrapper, so a run can show that its path went through the
kernels; each kernel module adds one where it launches, and the plain
versions are not counted.  ``LAUNCHES_BY_SHAPE`` counts the attention
kernels' and the SSD scan's and its backward's launches apart by (kernel,
``launch_key``).
"""
from __future__ import annotations

from . import cim_matmul as _cim
from . import flash_attention as _fa
from . import paged_attention as _pa
from . import pwl_softmax as _ps
from . import ssd_scan as _ssd
from ._build import LAUNCHES, LAUNCHES_BY_SHAPE


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCHES_BY_SHAPE.clear()


def _route(t) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {t.device}")
    return t.device.type


def flash_attention(q, k, v, *, causal: bool = True, use_pwl: bool = False,
                    window=None, prefix_len: int = 0, q_offset: int = 0):
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D).  Returns (B, Sq, Hq, D).
    ``window``: mask keys ``window`` or more positions before the query.
    ``prefix_len``: keys below it are visible to every query (causal).
    ``q_offset``: query row i sits at global position ``q_offset + i``
    (a rank's rows under sequence-parallel attention), keys at 0 .. Skv -
    1; every mask reads the global position."""
    kw = dict(causal=causal, use_pwl=use_pwl, window=window, prefix_len=prefix_len,
              q_offset=q_offset)
    if _route(q) == "cpu":
        return _fa.flash_attention_plain(q, k, v, **kw)
    return _fa.flash_attention_cuda(q, k, v, **kw)


def paged_attention(q, k_cache, v_cache, block_tables, context_lens, *,
                    use_pwl: bool = False, window=None):
    """q: (B, H, D); k/v_cache: (N, block_tokens, H_kv, D).  Returns (B, H, D).
    ``window``: mask the keys below ``context_lens - window``."""
    kw = dict(use_pwl=use_pwl, window=window)
    if _route(q) == "cpu":
        return _pa.paged_attention_plain(q, k_cache, v_cache, block_tables,
                                         context_lens, **kw)
    return _pa.paged_attention_cuda(q, k_cache, v_cache, block_tables,
                                    context_lens, **kw)


def paged_attention_partial(q, k_cache, v_cache, block_tables, context_lens, *,
                            key_offset: int = 0, window=None):
    """The float32 partial of one shard of a sequence-sharded KV cache
    (PICNIC decode): q (B, H, D); k/v_cache (N, block_tokens, H_kv, D), the
    shard's pool, whose local key j is global position ``key_offset + j``;
    ``context_lens`` (B,) global.  Returns (o (B, H, D), m (B, H), l (B,
    H)): o = sum exp(s - m) v, not normalised; m the max scaled score; l =
    sum exp(s - m); (0, NEG_INF, 0) for a head with no kept key.
    ``window``: mask the keys below ``context_lens - window``.  Exact exp
    only."""
    kw = dict(key_offset=key_offset, window=window)
    if _route(q) == "cpu":
        return _pa.paged_attention_plain(q, k_cache, v_cache, block_tables,
                                         context_lens, partial=True, **kw)
    return _pa.paged_attention_partial_cuda(q, k_cache, v_cache, block_tables,
                                            context_lens, **kw)


def ssd_scan(x, dt, a_neg, B, C, *, chunk: int):
    """x: (b, S, H, P); dt: (b, S, H); a_neg: (H,); B, C: (b, S, N).
    Returns y (b, S, H, P) and the final state (b, H, P, N), float32.
    ``chunk`` is the plain version's step; the kernel takes its own.  Under
    grad on the card the call goes through ``ssd_scan.SSDScanFn``."""
    if _route(x) == "cpu":
        return _ssd.ssd_scan_plain(x, dt, a_neg, B, C, chunk)
    return _ssd.ssd_scan_cuda(x, dt, a_neg, B, C)


def pwl_softmax(x):
    """SCU row softmax over the last dim of ``x (..., n)``, output in x's
    dtype."""
    if _route(x) == "cpu":
        return _ps.pwl_softmax_plain(x)
    return _ps.pwl_softmax_cuda(x)


def cim_matmul_quantized(x, wq, wscale, *, wqt=None, block_m: int = 128,
                         block_n: int = 256, adc_bits: int = 12,
                         act_bits: int = 8):
    """x: (M, K) float; wq: (K, N) int8; wscale: (K // 256, N) float32, as
    ``quantize_weights`` gives them; wqt: optionally wq in the kernel's
    (N, K) layout, ``cim_matmul.weight_layout(wq)`` of this very wq, made
    once per weight (its contents are not compared with wq: the kernel
    reads wqt, the CPU path wq).  Returns (M, N) float32.  The CPU path
    checks wqt's shape and ignores it."""
    kw = dict(block_m=block_m, block_n=block_n, adc_bits=adc_bits,
              act_bits=act_bits)
    if _route(x) == "cpu":
        _cim.check_layout(wqt, wq)
        return _cim.cim_matmul_plain(x, wq, wscale, **kw)
    return _cim.cim_matmul_cuda(x, wq, wscale, wqt=wqt, **kw)


def cim_matmul(x, w, *, weight_bits: int = 8, adc_bits: int = 12,
               act_bits: int = 8, block_m: int = 128, block_n: int = 256):
    """Quantise the weights ``w (K, N)``, then the CIM product."""
    wq, wscale = _cim.quantize_weights(w, bits=weight_bits)
    return cim_matmul_quantized(x, wq, wscale, block_m=block_m,
                                block_n=block_n, adc_bits=adc_bits,
                                act_bits=act_bits)
