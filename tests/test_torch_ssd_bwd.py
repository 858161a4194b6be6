"""The backward of the SSD scan: the port's plain version
(``ssd_scan_bwd_plain``, the reference for the Hopper kernel
``csrc/ssd_scan_bwd.cu``) against ``torch.autograd`` of the port's plain
forward ``ssd_scan_plain`` and against ``jax.vjp`` of the JAX model's
``repro.models.ssm.ssd_chunked``; the agreement rule the card holds the
kernel to.  CPU, float32, smoke widths (P 32, N 16, chunk 32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import ssd_chunked
from repro_torch.kernels import ssd_scan as ss
from repro_torch.kernels.ssd_scan import ssd_scan_bwd_plain, ssd_scan_plain

# float32 on both sides: the same gradients summed in another order and
# over other chunks, each within RTOL of the largest |value| of its
# reference; da_neg, a sum over every row of dt * da whose terms cancel
# (see ssd_scan.SSD_BWD_DA_REL), within DA_RTOL
RTOL = 2e-5
DA_RTOL = 2e-4
CHUNK = 32
NAMES = ("dx", "ddt", "da_neg", "dB", "dC")


def _inputs(b, S, H, P, N, *, memory, seed):
    """x, dt, a_neg, B, C, dy, dstate as numpy float32: dt = softplus(z +
    shift), ~0.7 for short memory, ~0.01 for long (the state carries over
    every chunk)."""
    rng = np.random.default_rng(seed)
    shift = {"short": 0.0, "long": -5.0}[memory]
    x = rng.standard_normal((b, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)) + shift)).astype(np.float32)
    a_neg = (-np.exp(0.2 * rng.standard_normal(H))).astype(np.float32)
    B, C = ((0.3 * rng.standard_normal((b, S, N))).astype(np.float32) for _ in range(2))
    dy = rng.standard_normal((b, S, H, P)).astype(np.float32)
    dstate = rng.standard_normal((b, H, P, N)).astype(np.float32)
    return x, dt, a_neg, B, C, dy, dstate


def _close(got, want, name, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    top = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= (DA_RTOL if name == "da_neg" else rtol) * top, (name, err, top)


CASES = [  # b, S, H, memory, dstate given
    (2, 37, 3, "short", True),      # S < 2 chunks, ragged
    (2, 100, 3, "long", False),     # ragged over 4 chunks, long memory
    (1, 64, 4, "long", True),
    (2, 100, 2, "short", False),
]


@pytest.mark.parametrize("b,S,H,memory,with_state", CASES)
def test_plain_backward_matches_autograd_of_the_plain_scan(b, S, H, memory, with_state):
    x, dt, a_neg, B, C, dy, dstate = _inputs(b, S, H, 32, 16, memory=memory, seed=S + H)
    leaves = [torch.from_numpy(t).requires_grad_() for t in (x, dt, a_neg, B, C)]
    y, state = ssd_scan_plain(*leaves, 256)         # the autograd side steps over 256 rows
    loss = (y * torch.from_numpy(dy)).sum()
    if with_state:
        loss = loss + (state * torch.from_numpy(dstate)).sum()
    want = torch.autograd.grad(loss, leaves)
    got = ssd_scan_bwd_plain(*(torch.from_numpy(t) for t in (x, dt, a_neg, B, C, dy)),
                             torch.from_numpy(dstate) if with_state else None, CHUNK)
    for name, a, w in zip(NAMES, got, want):
        assert a.dtype == torch.float32
        _close(a.numpy(), w.numpy(), name)


@pytest.mark.parametrize("b,S,H,memory,with_state", CASES)
def test_plain_backward_matches_jax_vjp_of_ssd_chunked(b, S, H, memory, with_state):
    x, dt, a_neg, B, C, dy, dstate = _inputs(b, S, H, 32, 16, memory=memory, seed=7 * S + H)
    (y_j, state_j), vjp = jax.vjp(lambda *a: ssd_chunked(*a, CHUNK), x, dt, a_neg, B, C)
    want = vjp((jnp.asarray(dy), jnp.asarray(dstate if with_state else np.zeros_like(dstate))))
    args = [torch.from_numpy(t) for t in (x, dt, a_neg, B, C)]
    got = ssd_scan_bwd_plain(*args, torch.from_numpy(dy),
                             torch.from_numpy(dstate) if with_state else None, CHUNK)
    for name, a, w in zip(NAMES, got, want):
        _close(a.numpy(), w, name)
    # the forward outputs, handed over as the kernel gets its forward's,
    # give the gradients the plain version gives with its own
    y, state = ssd_scan_plain(*args, CHUNK)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=1e-5)
    again = ssd_scan_bwd_plain(*args, torch.from_numpy(dy),
                               torch.from_numpy(dstate) if with_state else None, CHUNK,
                               y=y, state=state)
    for name, a, w in zip(NAMES, again, want):
        _close(a.numpy(), w, name)


def test_plain_backward_does_not_depend_on_the_chunk():
    """SSD is associative across chunks: the kernel's 32-row sub-chunks
    and the model's 256-row chunks give the same gradients up to float32
    rounding."""
    x, dt, a_neg, B, C, dy, dstate = _inputs(2, 300, 3, 32, 16, memory="long", seed=3)
    args = [torch.from_numpy(t) for t in (x, dt, a_neg, B, C, dy, dstate)]
    for name, a, w in zip(NAMES, ssd_scan_bwd_plain(*args, 32), ssd_scan_bwd_plain(*args, 256)):
        _close(a.numpy(), w.numpy(), name)


def test_plain_backward_keeps_the_inputs_dtypes():
    x, dt, a_neg, B, C, dy, _ = _inputs(1, 40, 2, 32, 16, memory="short", seed=4)
    bf = [torch.from_numpy(t).to(torch.bfloat16) for t in (x, B, C)]
    got = ssd_scan_bwd_plain(bf[0], torch.from_numpy(dt), torch.from_numpy(a_neg), bf[1], bf[2],
                             torch.from_numpy(dy), None, CHUNK)
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32, torch.float32,
                                      torch.bfloat16, torch.bfloat16]
    assert [tuple(t.shape) for t in got] == [(1, 40, 2, 32), (1, 40, 2), (2,), (1, 40, 16),
                                             (1, 40, 16)]


def test_bwd_agreement_rule():
    """The card's rule: float32 gradients within SSD_BWD_REL of their
    largest |value| (da_neg SSD_BWD_DA_REL); bf16 ones also one rounding
    apart per element; non-finite values fail."""
    w = torch.linspace(-2.0, 3.0, 50)
    assert ss.bwd_agreement(w + 2e-4, w, "dx")[2]
    assert not ss.bwd_agreement(w + 4e-4, w, "dx")[2]
    assert ss.bwd_agreement(w + 2e-3, w, "da_neg")[2]
    assert not ss.bwd_agreement(w + 4e-3, w, "da_neg")[2]
    wb = w.to(torch.bfloat16)
    step = (wb.float().abs() * 2.0 ** -8).to(torch.bfloat16)
    assert ss.bwd_agreement((wb.float() + step.float()).to(torch.bfloat16), wb, "dB")[2]
    # da_neg against its float64 value: within twice the plain float32
    # version's own distance from it, where that is past SSD_BWD_DA_REL
    exact = w.double()
    plain = w + 0.05
    assert ss.bwd_agreement(w - 0.09, plain, "da_neg", exact=exact)[2]
    assert not ss.bwd_agreement(w - 0.11, plain, "da_neg", exact=exact)[2]
    bad = w.clone()
    bad[3] = float("nan")
    assert not ss.bwd_agreement(bad, w, "dC")[2]
    with pytest.raises(ValueError):
        ss.bwd_agreement(w.to(torch.bfloat16), w, "dx")


def test_plain_scan_gradient_is_finite_where_ssd_chunked_overflows():
    """A 256-row chunk at dt 1 and A = -1: the decays above the diagonal
    reach +255, past float32's exp range.  jax.vjp of ssd_chunked is NaN
    in dt's and A's gradients there (ROADMAP hazard 11: exp is taken
    before the mask); the port's plain scan masks first, so autograd of
    it is finite, agrees with ssd_scan_bwd_plain, and its values are
    ssd_chunked's."""
    x, _, _, B, C, dy, _ = _inputs(1, 256, 2, 8, 4, memory="short", seed=9)
    dt = np.ones((1, 256, 2), np.float32)
    a_neg = -np.ones(2, np.float32)
    (y_j, _), vjp = jax.vjp(lambda *a: ssd_chunked(*a, 256), x, dt, a_neg, B, C)
    want_j = vjp((jnp.asarray(dy), jnp.zeros((1, 2, 8, 4), jnp.float32)))
    assert not np.isfinite(np.asarray(want_j[1])).all()          # the reference's fault
    leaves = [torch.from_numpy(t).requires_grad_() for t in (x, dt, a_neg, B, C)]
    y, _ = ssd_scan_plain(*leaves, 256)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), atol=1e-5)
    got = torch.autograd.grad((y * torch.from_numpy(dy)).sum(), leaves)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    want = ssd_scan_bwd_plain(*(torch.from_numpy(t) for t in (x, dt, a_neg, B, C, dy)), None, 32)
    for name, a, w in zip(NAMES, got, want):
        _close(a.numpy(), w.numpy(), name)
