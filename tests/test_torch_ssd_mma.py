"""The arithmetic of the bf16 tensor-core SSD scan (``csrc/ssd_scan.cu``,
``ssd_fwd_mma_kernel``), emulated on the CPU and held to the plain version
and to the JAX package's ``ssd_chunked``.

The emulation steps as the kernel does: sub-chunks in order (32 rows, the
kernel's; 64, the float32 kernel's, too), x, B and C in bf16 (exact operands of the tensor cores), float32 accumulation,
and each float32 operand of a product split into two bf16 terms,
``v = hi + lo`` with ``hi = bf16(v)`` and ``lo = bf16(v - hi)``, each term
multiplied on its own:

  S     = C Bᵀ                                     (bf16 x bf16)
  Att   = S ⊙ exp(cs_l - cs_m) ⊙ dt_m, m <= l      split -> Att x
  y     = Att x + exp(cs_l) · C stateᵀ             state split
  state = exp(cs_last) · state + (x ⊙ w)ᵀ B,       x ⊙ w split,
          w = dt · exp(cs_last - cs)

The bars are chip_smoke.py's (TOL_SSD for short memory, TOL_SSD_REL of
max |value| for long memory).  The same emulation with one bf16 rounding
of each float32 operand, or with the carried state's decay dropped, must
fail the long-memory bar: that shows the bar can see the faults the split
and the carry guard against.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.kernels.ssd_scan import ssd_scan_plain

# copied from chip_smoke.py, with the same values and reasons
TOL_SSD = 1e-3
TOL_SSD_REL = 1e-4
SUBS = (32, 64)    # sub-chunk rows: the bf16 kernel's, the float32 kernel's
CHUNK = 256        # the served models' chunk, the plain version's step


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _terms(v, split):
    """The bf16 terms a float32 operand goes to the tensor cores as."""
    hi = _bf16(v)
    return (hi, _bf16(v - hi)) if split else (hi,)


def ssd_mma_emulated(x, dt, a_neg, B, C, *, sub=32, split=True, decay_carry=True):
    """x: (b, S, H, P); dt: (b, S, H); a_neg: (H,); B, C: (b, S, N), all
    float32 (x, B and C already bf16 values), in sub-chunks of ``sub``
    rows.  Returns y (b, S, H, P) and the final state (b, H, P, N),
    float32."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    n_sub = -(-S // sub)
    pad = n_sub * sub - S
    # rows past S are zero, dt too, as the kernel's zero-filled copies
    x, dt, B, C = (torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                   for t in (x, dt, B, C))
    tri = torch.ones((sub, sub), dtype=torch.bool).tril()
    state = torch.zeros((b, H, P, N))
    ys = []
    for j in range(n_sub):
        rows = slice(j * sub, (j + 1) * sub)
        xk, dtk, Bk, Ck = x[:, rows], dt[:, rows], B[:, rows], C[:, rows]
        cs = torch.cumsum(dtk * a_neg, dim=1)                       # (b, L, H)
        seg = cs[:, :, None, :] - cs[:, None, :, :]                 # (b, l, m, H)
        decay = torch.where(tri[None, :, :, None], torch.exp(seg), torch.zeros(()))
        s = torch.einsum("bln,bmn->blm", Ck, Bk)
        att = s[..., None] * decay * dtk[:, None, :, :]             # (b, l, m, H)
        y = sum(torch.einsum("blmh,bmhp->blhp", t, xk) for t in _terms(att, split))
        off = sum(torch.einsum("bln,bhpn->blhp", Ck, t) for t in _terms(state, split))
        y = y + torch.exp(cs)[..., None] * off
        w = dtk * torch.exp(cs[:, -1:, :] - cs)                     # (b, L, H)
        xw = xk * w[..., None]
        upd = sum(torch.einsum("blhp,bln->bhpn", t, Bk) for t in _terms(xw, split))
        carry = torch.exp(cs[:, -1, :])[:, :, None, None] if decay_carry else 1.0
        state = state * carry + upd
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S], state


def _inputs(seed, b, S, H, P, N, memory):
    """chip_smoke.py's ssd cases: unit x, dt = softplus(N(0,1)) (short) or
    softplus(N(0,1) - 5) ~ 0.01 (long), A near -1, B and C at 0.3; x, B
    and C rounded to bf16, as the main path gives them."""
    rng = np.random.default_rng(seed)
    shift = {"short": 0.0, "long": -5.0}[memory]
    x = rng.standard_normal((b, S, H, P))
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)) + shift))
    a = -np.exp(0.2 * rng.standard_normal(H))
    B = 0.3 * rng.standard_normal((b, S, N))
    C = 0.3 * rng.standard_normal((b, S, N))
    t = [torch.from_numpy(v.astype(np.float32)) for v in (x, dt, a, B, C)]
    return _bf16(t[0]), t[1], t[2], _bf16(t[3]), _bf16(t[4])


def _errors(got, want, memory):
    """max |difference| of y and of state, each over its bar."""
    out = []
    for g, w in zip(got, want):
        w = torch.from_numpy(np.array(w, np.float32))
        tol = TOL_SSD if memory == "short" else TOL_SSD_REL * w.abs().max().item()
        out.append((g - w).abs().max().item() / tol)
    return out


CASES = [  # b, S, H, P, N
    (1, 512, 2, 64, 128),    # the main path's P and N, eight sub-chunks
    (2, 300, 3, 64, 128),    # ragged S
    (1, 100, 4, 32, 16),     # ragged S, the smallest N
    (2, 40, 2, 64, 16),      # S below one 64-row sub-chunk
    (1, 20, 2, 64, 16),      # S below one 32-row sub-chunk
]


@pytest.mark.parametrize("sub", SUBS)
@pytest.mark.parametrize("memory", ["short", "long"])
@pytest.mark.parametrize("b,S,H,P,N", CASES)
def test_emulated_mma_arithmetic_meets_the_card_bars(b, S, H, P, N, memory, sub):
    args = _inputs(S + N, b, S, H, P, N, memory)
    got = ssd_mma_emulated(*args, sub=sub)
    assert got[0].shape == (b, S, H, P) and got[1].shape == (b, H, P, N)
    plain = ssd_scan_plain(*args, CHUNK)
    jax_ref = jssm.ssd_chunked(*(jnp.asarray(t.numpy()) for t in args), CHUNK)
    for want in (plain, jax_ref):
        # within a quarter of each bar: what the card adds is float32 ordering
        ratios = _errors(got, want, memory)
        assert max(ratios) <= 0.25, ratios


@pytest.mark.parametrize("b,S,H,P,N", [(1, 512, 2, 64, 128), (2, 300, 3, 64, 128)])
def test_single_bf16_rounding_fails_the_long_memory_bar(b, S, H, P, N):
    args = _inputs(S + N, b, S, H, P, N, "long")
    got = ssd_mma_emulated(*args, split=False)
    assert max(_errors(got, ssd_scan_plain(*args, CHUNK), "long")) > 1.0


@pytest.mark.parametrize("b,S,H,P,N", [(1, 512, 2, 64, 128), (1, 100, 4, 32, 16)])
def test_dropped_state_decay_fails_the_long_memory_bar(b, S, H, P, N):
    args = _inputs(S + N, b, S, H, P, N, "long")
    got = ssd_mma_emulated(*args, decay_carry=False)
    assert max(_errors(got, ssd_scan_plain(*args, CHUNK), "long")) > 1.0
