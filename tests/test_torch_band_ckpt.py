"""K8 on the band-pipelined wavefront (``csrc/band_sweep.cuh``'s kBandCkpt
mode), emulated in plain PyTorch by
``cuda_solver.inc_adjoint_ckpt_banded_plain``: each warp of 32 forward rows
takes the stored diagonal pair of each window from the sparse stack alone
and recomputes the window's other ``W - 2`` diagonals at its rows and at a
halo of ``W - 2`` rows above them, by the kernel's index arithmetic
(``cuda_solver.ckpt_warp_stack``); the reverse frame is swept from a row 0
of 1s in bands of ``H`` rows and chunks of ``Wc`` columns, each cell
multiplied by the recomputed forward value and collapsed lane by lane into
``ct`` in the pairs' own frame (``cuda_blocked.banded_adjoint``). It must
equal the plain K8 (``inc_adjoint_ckpt_plain``) and the plain K3<inc> on
the full stack (``inc_adjoint_plain``) bit for bit over both dtypes, both
schemes, dyadic orders 0, 1, 2 and 5, transposed grids (``Mb > Nb``),
frames whose rows are no multiple of 32 or of ``H``, frames smaller than
the window, a warp whose halo reaches forward row 0, and windows of 2, 3
and 8 diagonals; and, through the backward route, JAX's
``_grid_route_bwd`` on its scan tier.

The recompute's values that leave what a warp holds are NaN in the
emulation, so a halo too short to hold a cone shows. The negative controls:
a halo one row short, and the top row's neighbour read from the stored
pair instead of the halo, each make the cotangent differ on every case
here where it can change a value (R > 32, the halo inside the frame's
rows, and for the second a recomputed diagonal: 11 of them).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigkernel_tpu as sk
from sigkernel_tpu.ops import solve as jsolve
from sigkernel_tpu.utils import double_difference as jdd

from sigkernel_tpu_torch.ops import (_build, cuda_blocked, cuda_solver,
                                     routes, solve)

from conftest import make_paths

# (Mb, Nb, dyadic, W, H, Wc): R = min(Mb, Nb) 2^dyadic forward rows, the
# grid transposed in the solve's frame when Mb > Nb; bands of H rows and
# chunks of Wc columns, the last ones short on most frames ((128, 32) are
# the kernel's own)
_CASES = [
    (2, 3, 0, 8, 16, 8),      # R 2, C 3: the frame smaller than a window
    (3, 2, 0, 3, 16, 8),      # the same, transposed, W 3
    (9, 14, 1, 8, 8, 5),      # R 18: a short last band
    (14, 9, 1, 3, 16, 13),    # transposed
    (10, 25, 0, 2, 16, 8),    # W 2: no diagonal recomputed
    (36, 45, 0, 8, 32, 13),   # R 36: warp 0's halo reaches row 0
    (40, 50, 0, 8, 16, 8),    # R 40: two warps, the second of 8 rows
    (33, 40, 0, 3, 128, 32),  # R 33: a second warp of one row, W 3
    (17, 12, 2, 8, 32, 13),   # R 44, transposed, dyadic 2
    (70, 75, 0, 8, 128, 32),  # R 70: three warps, the last short
    (2, 3, 5, 8, 32, 13),     # dyadic 5: a base row is a whole warp
    (3, 2, 5, 3, 16, 8),      # dyadic 5, transposed
]


def _case_id(case):
    return "-".join(map(str, case))


def _grid(Mb, Nb, dtype, seed, P=2):
    rng = np.random.default_rng(seed)
    X = make_paths(rng, P, Mb + 1, 3, scale=0.6)
    Y = make_paths(rng, P, Nb + 1, 3, scale=0.6)
    inc = jdd(sk.RBFKernel(0.6).batch_kernel(X, Y))
    return torch.tensor(np.asarray(inc), dtype=dtype)


def _sparse(monkeypatch, inc, dyadic, naive, W):
    monkeypatch.setattr(cuda_solver, "CKPT_WINDOW", W)
    return cuda_solver.inc_solve_sparse_plain(inc, dyadic, naive)[1]


@pytest.mark.parametrize("case", _CASES, ids=_case_id)
@pytest.mark.parametrize("naive", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_banded_k8_is_the_plain_k8(monkeypatch, dtype, naive, case):
    Mb, Nb, dyadic, W, H, Wc = case
    inc = _grid(Mb, Nb, dtype, Mb + 3 * Nb + dyadic)
    sparse = _sparse(monkeypatch, inc, dyadic, naive, W)
    got = cuda_solver.inc_adjoint_ckpt_banded_plain(inc, sparse, dyadic,
                                                    naive, H, Wc)
    want = cuda_solver.inc_adjoint_ckpt_plain(inc, sparse, dyadic, naive)
    _, stack = cuda_solver.inc_solve_stack_plain(inc, dyadic, naive)
    assert got.dtype == dtype and got.shape == inc.shape
    assert torch.equal(got, want)
    assert torch.equal(got, cuda_solver.inc_adjoint_plain(inc, stack, dyadic,
                                                          naive))


def _bites(case, control):
    """Can the control change a value? Warp 0's top row is R - 32. A halo
    one row short loses a value only if its lowest row lies inside the
    frame (row 0 and above take their edge values and read no neighbour):
    R - 32 >= W - 2. The top row's neighbour read from the stored pair
    differs from the halo's only if a diagonal is recomputed (W >= 4) and
    that neighbour is not the boundary row 0, constant along diagonals."""
    Mb, Nb, dyadic, W = case[:4]
    top = min(Mb, Nb) * 2 ** dyadic - 32
    if control == "halo one row short":
        return W >= 3 and top >= W - 2
    return W >= 4 and top >= 2


_CONTROLS = [(c, k) for c in _CASES
             for k in ("halo one row short", "top from pair") if _bites(c, k)]


@pytest.mark.parametrize("case,control", _CONTROLS,
                         ids=[f"{_case_id(c)}-{k}" for c, k in _CONTROLS])
def test_negative_controls_break_the_bit_equality(monkeypatch, case,
                                                  control):
    """The halo is needed whole: one row short, or the warp's top row fed
    from the stored pair, and the cotangent differs, wherever the control
    can change a value (:func:`_bites`)."""
    assert len(_CONTROLS) == 11
    Mb, Nb, dyadic, W, H, Wc = case
    inc = _grid(Mb, Nb, torch.float64, Mb + 3 * Nb + dyadic)
    sparse = _sparse(monkeypatch, inc, dyadic, False, W)
    want = cuda_solver.inc_adjoint_ckpt_plain(inc, sparse, dyadic)
    broken = ({"halo": W - 3} if control == "halo one row short"
              else {"top_from_pair": True})
    got = cuda_solver.inc_adjoint_ckpt_banded_plain(inc, sparse, dyadic,
                                                    False, H, Wc, **broken)
    assert not torch.equal(got, want)


def test_warp_stack_holds_every_value_the_adjoint_reads(monkeypatch):
    """The recomputed values are the full stack's wherever the adjoint reads
    them (forward rows 0 .. R - 1 of diagonals 0 .. R + C - 2, within the
    frame's columns), NaN-free, and NaN past the frame's rows."""
    inc = _grid(40, 50, torch.float64, 7)
    sparse = _sparse(monkeypatch, inc, 0, False, 8)
    _, stack = cuda_solver.inc_solve_stack_plain(inc, 0)
    u = cuda_blocked._band_increments(inc, 1, 0, 40, False)
    fwd = cuda_solver.ckpt_warp_stack(sparse, u, 8)
    p = torch.arange(40 + 50 - 1)[:, None]
    a = torch.arange(40)[None, :]
    read = (p - a >= 0) & (p - a < 50)
    got, want = fwd[:, :89, :40], stack[:, :89, :40]
    assert torch.equal(got[:, read], want[:, read])
    assert torch.isnan(fwd[:, :, 40]).all()


@pytest.fixture
def ckpt_route_banded(monkeypatch):
    """Steer every tile on CPU tensors onto the ``inc`` family's ``ckpt``
    tier, with K8 emulated band by band (bands of 8 rows, chunks of 5
    columns); yields the emulation's call count."""
    orig = routes.resolve_family

    def steered(static_kernel, device_type, solver, **gates):
        if solver == "scan":
            return orig(static_kernel, device_type, solver, **gates)
        return "inc"

    calls = []

    def adjoint(inc, sparse, dyadic_order=0, naive=False):
        calls.append(1)
        return cuda_solver.inc_adjoint_ckpt_banded_plain(
            inc, sparse, dyadic_order, naive, 8, 5)

    monkeypatch.setattr(routes, "resolve_family", steered)
    monkeypatch.setattr(routes, "CKPT_MIN_PAIRS", 1 << 40)
    monkeypatch.setattr(cuda_solver, "inc_adjoint_ckpt", adjoint)
    yield calls


@pytest.mark.parametrize("naive", [False, True])
def test_backward_route_on_the_band_k8_matches_jax(rng, ckpt_route_banded,
                                                   naive):
    """The ``inc`` family's backward on the ``ckpt`` tier, K8 emulated band
    by band, against JAX ``_grid_route_bwd`` on the scan tier: float64
    within 1e-9 of max |grad|."""
    X = make_paths(rng, 3, 37, 2, scale=0.6)
    Y = make_paths(rng, 3, 21, 2, scale=0.6)
    inc = np.asarray(jdd(sk.RBFKernel(0.6).batch_kernel(X, Y)))
    g = rng.normal(size=3)
    (want,) = jsolve._grid_route_bwd(jnp.asarray(inc), jnp.asarray(g), naive,
                                     "scan", 1)
    got = solve.inc_route_bwd(torch.tensor(inc), torch.tensor(g), naive, 1)
    assert ckpt_route_banded
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-9 * np.abs(want).max()


@pytest.fixture
def posing_as_cuda(monkeypatch):
    """Meta tensors stand in for CUDA ones: the grid check passes and each
    launch is recorded, ``(name, fns, key, args)``, instead of run."""
    launches = []
    monkeypatch.setattr(cuda_solver, "_check", lambda inc, what: None)
    monkeypatch.setattr(_build, "launch", lambda what, fns, counts, t, *args,
                        key=None: launches.append((what, fns, key, args)))
    return launches


def _meta(Mb, Nb, dyadic, P=2):
    f = 2 ** dyadic
    inc = torch.empty(P, Mb, Nb, device="meta", dtype=torch.float64)
    sparse = torch.empty(cuda_solver.sparse_shape(P, Mb * f, Nb * f),
                         device="meta", dtype=torch.float64)
    return inc, sparse


def test_route_rule_and_the_one_block_bound(posing_as_cuda, monkeypatch):
    """The band kernel while f <= 32 and the window's halo fits a warp (W <=
    34), counted under the dtype and past the one-block row bound; the
    one-block kernel otherwise, under ``"one_block"``, and only there the
    row bound; the emulation refuses what the band kernel cannot run."""
    assert [cuda_solver.ckpt_kernel(d, 8) for d in range(8)] == (
        ["band"] * 6 + ["one_block"] * 2)
    assert [cuda_solver.ckpt_kernel(2, W) for W in (2, 34, 35)] == [
        "band", "band", "one_block"]
    assert "one_block" in cuda_solver.CKPT_COUNTS
    monkeypatch.setattr(_build, "max_rows", lambda itemsize: 150)
    for Mb, Nb, dyadic, W in [(9, 6, 5, 8), (6, 9, 1, 34), (2, 3, 6, 8),
                              (40, 50, 0, 35)]:
        monkeypatch.setattr(cuda_solver, "CKPT_WINDOW", W)
        inc, sparse = _meta(Mb, Nb, dyadic)
        ct = cuda_solver.inc_adjoint_ckpt(inc, sparse, dyadic, True)
        assert ct.shape == inc.shape
        what, fns, key, args = posing_as_cuda.pop()
        R, f = min(Mb, Nb) * 2 ** dyadic, 2 ** dyadic
        if cuda_solver.ckpt_kernel(dyadic, W) == "band":  # R 192 at dyadic 5
            assert fns is cuda_solver._CKPT_FNS and key is None
            assert args[5:] == (2, Mb, Nb, f, W, -(-R // 128), 1)
        else:
            assert fns is cuda_solver._CKPT_ONE_BLOCK_FNS
            assert key == "one_block" and args[-2:] == (W, 1)
    monkeypatch.setattr(cuda_solver, "CKPT_WINDOW", 8)
    inc, sparse = _meta(3, 4, 7)  # R 384: past the one-block row bound
    with pytest.raises(ValueError, match="shared memory"):
        cuda_solver.inc_adjoint_ckpt(inc, sparse, 7)
    cpu = torch.zeros(1, 3, 4, dtype=torch.float64)
    with pytest.raises(ValueError, match="one warp"):
        cuda_solver.inc_adjoint_ckpt_banded_plain(cpu, None, 6)


def test_band_launches_split_by_the_ticket_bound(posing_as_cuda,
                                                 monkeypatch):
    """With the ticket bound cut to two pairs' blocks, K8 launches in
    chunks of two pairs, each launch's grid, sparse stack and ct further
    on, with freshly zeroed counters."""
    inc, sparse = _meta(140, 150, 0, P=5)  # R 140: two bands
    monkeypatch.setattr(cuda_solver, "TICKETS", 2 * 2 + 1)
    cuda_solver.inc_adjoint_ckpt(inc, sparse)
    assert [args[5] for *_, args in posing_as_cuda] == [2, 2, 1]
    per_grid, per_sparse = 140 * 150 * 8, sparse[0].numel() * 8
    for n, (_, _, _, args) in enumerate(posing_as_cuda):
        assert args[0] == per_grid * 2 * n and args[2] == per_grid * 2 * n
        assert args[1] == per_sparse * 2 * n
