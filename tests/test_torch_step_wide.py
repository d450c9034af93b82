"""K3's wide tier (nq 15-30) on the CPU: its plain version against the JAX
package's kernel, and the plain emulation of its passes.

``fused_trotter_step`` runs ``csrc/fused_step_wide.cu`` on CUDA tensors from
15 qubits up, in passes over device memory with the phases inside the
passes (``test_torch_cuda.py`` and ``chip_smoke.py`` phase 9 hold it to its
plain version on the card). Here ``fused_trotter_step_passes`` runs the same
masks, per-row tables and pass order in plain torch, with ``tile_bits``
small enough that widths 9-16 take one to three high passes. Run alone::

    python -m pytest -q -p no:cacheprovider tests/test_torch_step_wide.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlqem_tpu.ops.pallas.fused_step import \
    fused_trotter_step as j_fused_trotter_step

from mlqem_tpu_torch.ops import kicked_ising
from mlqem_tpu_torch.ops.kernels import fused_step as kfs
from mlqem_tpu_torch.ops.kernels import wht as kwht
from mlqem_tpu_torch.ops.kicked_ising import _sign_tables, kicked_steps
from mlqem_tpu_torch.utils.profiling import reset_spans, span_totals, tracing

from port_fixtures import one_torch_thread  # noqa: F401

THETA_H = 0.9


def _inputs(w, rows, seed, nb=None):
    """Unit-norm planes, ±1 signs, θJ and the chain's tables (nb = w − 1),
    or nb random ±1 parity columns."""
    rng = np.random.default_rng(seed)
    bit_pm, bond_par = _sign_tables(w)
    if nb is not None:
        bond_par = rng.choice([-1.0, 1.0], size=(2 ** w, nb))
    nb = bond_par.shape[1]
    re = rng.normal(size=(rows, 2 ** w))
    im = rng.normal(size=(rows, 2 ** w))
    norm = np.sqrt((re ** 2 + im ** 2).sum(axis=1, keepdims=True))
    arrays = [re / norm, im / norm, rng.choice([-1.0, 1.0], size=(rows, w)),
              rng.choice([-1.0, 1.0], size=(rows, nb)),
              rng.uniform(-1.2, -0.1, size=(rows, 1)), bit_pm, bond_par]
    return [np.ascontiguousarray(a, np.float32) for a in arrays]


def _torch(arrays):
    return [torch.as_tensor(a) for a in arrays]


def _row_relative(got, want):
    """max|Δ| over each row's largest |want| (both planes)."""
    want = [np.asarray(x, np.float64) for x in want]
    scale = np.maximum(np.abs(want[0]).max(axis=1),
                       np.abs(want[1]).max(axis=1))[:, None]
    return max(float((np.abs(np.asarray(g, np.float64) - x) / scale).max())
               for g, x in zip(got, want))


@pytest.mark.parametrize("w", [15, 16])
def test_plain_step_matches_jax_interpret(w):
    """The port's plain K3 at the wide tier's widths against the JAX
    package's kernel in interpret mode (A × L = 2^(w−7) × 128)."""
    arrays = _inputs(w, 2, seed=w)
    run = jax.jit(lambda *a: j_fused_trotter_step(
        *a, THETA_H, A=2 ** (w - 7), L=128, block_rows=2, interpret=True))
    want = run(*(jnp.asarray(a) for a in arrays))
    got = kfs.fused_trotter_step(*_torch(arrays), THETA_H)
    assert _row_relative([g.numpy() for g in got], want) <= 1e-5


@pytest.mark.parametrize("w,tile_bits,passes", [
    (9, 7, 1), (10, 6, 4), (11, 8, 1), (12, 8, 2), (12, 7, 3), (13, 9, 1),
    (14, 8, 2), (15, 13, 1), (15, 9, 2), (16, 8, 3), (16, 13, 1)])
def test_passes_match_the_plain_step(w, tile_bits, passes):
    """The emulated passes (low pass, high passes around the RX phase, low
    pass with the ZZ phase) equal the plain step."""
    assert len(kfs.high_groups(w, tile_bits)) == passes
    args = _torch(_inputs(w, 3, seed=100 + w))
    got = kfs.fused_trotter_step_passes(*args, THETA_H, tile_bits=tile_bits)
    want = kfs.fused_trotter_step_reference(*args, THETA_H)
    assert _row_relative(got, want) <= 1e-6


@pytest.mark.parametrize("w,nb", [(15, None), (16, None), (12, 32),
                                  (15, 32), (10, 0)])
def test_passes_take_every_bond_count(w, nb):
    """The chain windows' nb = w − 1 bonds at 15-16 qubits, and parity
    tables of up to 32 columns (the wide tier's MAX_NB) or none."""
    args = _torch(_inputs(w, 2, seed=7 * w, nb=nb))
    assert args[6].shape[1] == (w - 1 if nb is None else nb)
    got = kfs.fused_trotter_step_passes(*args, THETA_H, tile_bits=9)
    want = kfs.fused_trotter_step_reference(*args, THETA_H)
    assert _row_relative(got, want) <= 1e-6


@pytest.mark.parametrize("w,nb", [(5, None), (15, None), (9, 32)])
def test_mask_words_reproduce_the_tables(w, nb):
    """Bit q of word j is set exactly where bit_pm[j, q] = −1, bit k of word
    2^w + j where bond_par[j, k] = −1; the last word flags bad tables."""
    bit_pm, bond_par = _torch(_inputs(w, 1, seed=w, nb=nb)[5:])
    masks = kfs.step_masks(bit_pm, bond_par)     # CPU: the plain version
    assert masks.dtype == torch.int32 and masks.shape == (2 ** (w + 1) + 1,)
    words = masks[:-1].to(torch.int64) & 0xFFFFFFFF
    dim = 2 ** w

    def table(word, n):
        return 1.0 - 2.0 * ((word[:, None] >> torch.arange(n)) & 1).float()

    assert torch.equal(table(words[:dim], w), bit_pm)
    assert torch.equal(table(words[dim:], bond_par.shape[1]), bond_par)
    assert int(masks[-1]) == 0
    assert int(kfs.step_masks(bit_pm, bond_par * 0.5)[-1]) == 1


def test_passes_poison_bad_tables_and_take_other_signs():
    """A table entry other than ±1 makes every output NaN; rows whose signs
    are not all ±1 get the plain version's result."""
    args = _torch(_inputs(12, 3, seed=12))
    bad = list(args)
    bad[5] = args[5].clone()
    bad[5][7, 2] = 0.5
    re, im = kfs.fused_trotter_step_passes(*bad, THETA_H, tile_bits=8)
    assert torch.isnan(re).all() and torch.isnan(im).all()
    odd = list(args)
    odd[2] = args[2].clone()
    odd[2][1, 3] = 0.25
    odd[3] = args[3].clone()
    odd[3][2, 0] = -2.0
    got = kfs.fused_trotter_step_passes(*odd, THETA_H, tile_bits=8)
    want = kfs.fused_trotter_step_reference(*odd, THETA_H)
    assert _row_relative(got, want) <= 1e-6


@pytest.mark.parametrize("w,tile_bits", [(16, 13), (16, 8), (11, 6)])
def test_every_pass_tiles_each_row_once(w, tile_bits):
    """Each pass's tiles, as the kernel places them, cover every amplitude
    of a row once, and a high pass's tile rows step through its bits."""
    for lo, k in [(0, tile_bits)] + kfs.high_groups(w, tile_bits):
        at = kfs._tile_amplitudes(w, lo, k, tile_bits)
        assert torch.equal(torch.sort(at.reshape(-1)).values,
                           torch.arange(2 ** w))
        if lo:
            step = at[0, 1 << kfs.COL_BITS] - at[0, 0]
            assert step == 1 << lo


def test_table_free_call_on_the_cpu_runs_the_passes(monkeypatch):
    """Given masks and no tables, the wrapper runs the emulation on CPU
    tensors, and no CPU call builds a kernel."""
    def no_build():
        raise AssertionError("a CPU tensor must not reach the kernel")

    monkeypatch.setattr(kfs, "load_wide_library", no_build)
    monkeypatch.setattr(kfs, "load_library", no_build)
    args = _torch(_inputs(15, 2, seed=3))
    masks = kfs.step_masks(args[5], args[6])
    got = kfs.fused_trotter_step(*args[:5], None, None, THETA_H, masks=masks)
    want = kfs.fused_trotter_step(*args, THETA_H)
    assert _row_relative(got, want) <= 1e-6


@pytest.mark.parametrize("w", [13, 15, 16])
def test_kicked_steps_calls_k3_once_a_step(w, monkeypatch):
    """kicked_steps takes K3's wrapper at every width, one call a step, the
    wide tier's masks built once a call, and never K4; use_kernel=False
    takes the plain version."""
    calls = {"fused_trotter_step": 0, "step_masks": 0, "wht_planes": 0}

    def counting(mod, name):
        fn = getattr(mod, name)

        def counted(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)

    counting(kfs, "fused_trotter_step")
    counting(kfs, "step_masks")
    counting(kwht, "wht_planes")
    steps, rows = 3, 2
    arrays = _inputs(w, rows, seed=w)
    bit_pm, bond_par = _torch(arrays[5:])
    rng = np.random.default_rng(w)
    kick = torch.as_tensor(rng.choice([-1.0, 1.0], size=(rows, steps, w)),
                           dtype=torch.float32)
    bond = torch.as_tensor(rng.choice([-1.0, 1.0],
                                      size=(rows, steps, w - 1)),
                           dtype=torch.float32)
    theta = torch.as_tensor(arrays[4][:, 0])
    re = torch.zeros((rows, 2 ** w))
    re[:, 0] = 1.0
    reset_spans()
    with tracing():
        got = kicked_steps(re, torch.zeros_like(re), kick, bond, theta,
                           bit_pm, bond_par, THETA_H, steps)
    assert calls == {"fused_trotter_step": steps,
                     "step_masks": int(w > kfs.MAX_CHIP_NQ),
                     "wht_planes": 0}
    assert {p: t["count"] for p, t in span_totals().items()} == {
        "kicked.step": steps}
    want = kicked_steps(re, torch.zeros_like(re), kick, bond, theta, bit_pm,
                        bond_par, THETA_H, steps, use_kernel=False)
    assert calls["fused_trotter_step"] == steps
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    assert not hasattr(kicked_ising, "_rotate_")
