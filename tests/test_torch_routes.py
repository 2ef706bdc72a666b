"""The port's one route resolver, over its whole matrix, and the port's
independence from JAX."""
import os
import subprocess
import sys

import pytest
import torch

import sigkernel_tpu_torch as skt
from sigkernel_tpu_torch.ops import routes


class _ScaledRBF(skt.RBFKernel):
    """Not exactly ``RBFKernel``: must not take the RBF generation kernel."""


_KERNELS = {
    "rbf": skt.RBFKernel(0.5),
    "linear": skt.LinearKernel(1.0),
    "rbf_subclass": _ScaledRBF(0.5),
    "linear_subclass": skt.Linear_ID_Kernel(),  # must not take K6 either
    "functional": skt.RBF_SQR_Kernel(0.5, 1.0),
    "grid": None,  # a ready increment grid (ops.solve)
}

# (kernel, device type, solver) -> family, or the error it raises
_EXPECTED = {}
for _k in _KERNELS:
    for _dev in ("cpu", "cuda"):
        _EXPECTED[(_k, _dev, "scan")] = "scan"
    _EXPECTED[(_k, "cpu", "auto")] = "scan"
    _EXPECTED[(_k, "cpu", "cuda")] = ValueError
    for _solver in ("auto", "cuda"):
        _EXPECTED[(_k, "cuda", _solver)] = {"rbf": "gen",
                                            "linear": "lgen"}.get(_k, "inc")


@pytest.mark.parametrize("kernel,device,solver", sorted(_EXPECTED))
def test_resolve_family_matrix(kernel, device, solver):
    want = _EXPECTED[(kernel, device, solver)]
    if want is ValueError:
        with pytest.raises(ValueError, match="CUDA"):
            routes.resolve_family(_KERNELS[kernel], device, solver)
    else:
        assert routes.resolve_family(_KERNELS[kernel], device,
                                     solver) == want
        assert want in routes.FAMILIES


@pytest.mark.parametrize("solver", ["pallas", "gen", "", "CUDA"])
def test_unknown_solver_lists_the_options(solver):
    with pytest.raises(ValueError, match="'auto', 'scan', 'cuda'"):
        routes.resolve_family(skt.RBFKernel(1.0), "cuda", solver)


# (family, input dtype, grad_solver) -> backward dtype
_F32, _F64 = torch.float32, torch.float64
_BWD = {}
for _fam in routes.FAMILIES:
    for _dt in (_F32, _F64):
        for _grade in routes.GRAD_SOLVERS:
            _BWD[(_fam, _dt, _grade)] = (
                _F32 if _fam != "scan" and _grade == "f32" else _dt)


@pytest.mark.parametrize("family,dtype,grade", sorted(
    _BWD, key=lambda k: (k[0], str(k[1]), k[2])))
def test_backward_dtype_matrix(family, dtype, grade):
    """f64 in: "f32" is the float32 chain, "auto"/"df64" native double; f32
    in: float32; the plain (scan) family always at the input precision."""
    kernel, device, solver = {
        "gen": (_KERNELS["rbf"], "cuda", "auto"),
        "lgen": (_KERNELS["linear"], "cuda", "auto"),
        "inc": (_KERNELS["functional"], "cuda", "auto"),
        "scan": (_KERNELS["rbf"], "cpu", "auto")}[family]
    route = routes.resolve(kernel, device, solver, dtype, grade)
    assert route == routes.Route(family, _BWD[(family, dtype, grade)])


def test_unknown_grad_solver_raises():
    with pytest.raises(ValueError, match="'auto', 'f32', 'df64'"):
        routes.resolve(None, "cuda", "auto", torch.float64, "f64")


# the derivative Gram: (device type, solver, an input needs a gradient,
# refined shape, itemsize) -> route, or the error it raises. K5 has no row
# bound: the shapes sit at and past the bounds of its earlier one-block
# kernel (4,840 rows in double, 9,683 in float), and all route alike.
_K5_ROWS = {8: 4840, 4: 9683}
_SHAPES = [(_shape, _size) for _size, _b in _K5_ROWS.items()
           for _shape in ((2046, 2046), (_b, _b + 7), (_b + 7, _b),
                          (_b + 1, _b + 1), (_b + 1, 30000))]
_DERIV = {}
for _shape, _size in _SHAPES:
    for _dev in ("cpu", "cuda"):
        for _grad in (False, True):
            _DERIV[(_dev, "scan", _grad, _shape, _size)] = "scan"
            _DERIV[(_dev, "cuda", _grad, _shape, _size)] = (
                "CUDA tensors" if _dev == "cpu" else
                "forward only" if _grad else "cuda")
            _DERIV[(_dev, "auto", _grad, _shape, _size)] = (
                "scan" if _dev == "cpu" else
                "forward only" if _grad else "cuda")


@pytest.mark.parametrize("device,solver,needs_grad",
                         sorted({k[:3] for k in _DERIV}))
def test_resolve_derivatives_matrix(device, solver, needs_grad):
    """K5 for CUDA tensors at every shape, forward only: an input that needs
    a gradient raises there rather than come back detached; the plain sweep
    on the CPU or when asked. Each refined shape at and one past the old
    one-block bound, both orientations, 30,000 columns, both itemsizes."""
    for shape, itemsize in _SHAPES:
        want = _DERIV[(device, solver, needs_grad, shape, itemsize)]
        args = (device, solver, needs_grad, shape, itemsize)
        if want in routes.DERIV_ROUTES:
            assert routes.resolve_derivatives(*args) == want
        else:
            with pytest.raises(ValueError, match=want):
                routes.resolve_derivatives(*args)


@pytest.mark.parametrize("itemsize", [4, 8])
def test_k5_bound_is_cuda_deriv_max_rows(itemsize):
    """K5 has no row bound in either itemsize: ``cuda_deriv`` names none,
    and past its earlier kernel's bound, up to 30,000 rows, the CUDA route
    stays K5 without a gradient and raises (forward only) with one."""
    from sigkernel_tpu_torch.ops import cuda_deriv

    assert not hasattr(cuda_deriv, "max_rows")
    assert not hasattr(cuda_deriv, "check_rows")
    b = _K5_ROWS[itemsize]
    for shape in ((b, b), (b + 1, b + 1), (30000, 30000)):
        for solver in ("auto", "cuda"):
            assert routes.resolve_derivatives("cuda", solver, False, shape,
                                              itemsize) == "cuda"
            with pytest.raises(ValueError, match="forward only"):
                routes.resolve_derivatives("cuda", solver, True, shape,
                                           itemsize)


def test_resolve_derivatives_unknown_solver_lists_the_options():
    with pytest.raises(ValueError, match="'auto', 'scan', 'cuda'"):
        routes.resolve_derivatives("cuda", "pallas", False, (10, 10), 8)


# the inc family's tier on the card, by refined shape and the backward's
# itemsize: (MM, NN, itemsize, backward) -> tier. The row bound is 9,684
# rows in double and 19,369 in float; the ckpt gate of K2-stack -> K3<inc>
# takes the sparse stack when STACK_BYTES (8 GiB) holds fewer than 128
# pairs' full stacks.
_TIERS = {
    (2046, 2046, 8, False): "single",     # the north star
    (2046, 2046, 8, True): "full",        # 67 MB a pair: 128 a chunk
    (2046, 2046, 4, True): "full",
    (4092, 4092, 8, False): "single",     # BASELINE config 4
    (4092, 4092, 8, True): "ckpt",        # 268 MB a pair: 32 a chunk
    (4092, 4092, 4, True): "ckpt",        # 134 MB: 64 a chunk
    (8192, 8192, 4, True): "ckpt",        # length 2,049, dyadic 2
    (9684, 20000, 8, False): "single",    # at the row bound
    (9685, 20000, 8, False): "stripes",
    (9685, 20000, 8, True): "striped",
    (20000, 20000, 8, False): "stripes",  # length 5,001, dyadic 2
    (20000, 20000, 4, False): "stripes",
    (20000, 20000, 4, True): "striped",
    (19369, 19369, 4, False): "single",
    (0, 20000, 8, True): "full",          # a length-1 path: nothing stored
}


@pytest.mark.parametrize("MM,NN,itemsize,backward", sorted(_TIERS))
def test_resolve_inc_tier_matrix(MM, NN, itemsize, backward):
    want = _TIERS[(MM, NN, itemsize, backward)]
    assert routes.resolve_inc_tier((MM, NN), itemsize, backward) == want
    assert routes.resolve_inc_tier((NN, MM), itemsize, backward) == want
    assert want in (routes.INC_BWD_TIERS if backward else routes.INC_TIERS)


# the backward tier at the generator's ckpt gate (K1-stack -> K3<gen>: full
# while STACK_BYTES holds at least 64 pairs' full stacks): (MM, NN,
# itemsize) -> tier
_GEN_TIERS = {
    (2046, 2046, 8): "full",       # 128 a chunk
    (2895, 2895, 8): "full",       # 64 a chunk: the gate
    (2896, 2896, 8): "ckpt",       # 63 a chunk
    (4092, 4092, 8): "ckpt",       # phase 12's size: 32 a chunk
    (4092, 4092, 4): "full",       # 64 a chunk
    (8192, 8192, 4): "ckpt",       # length 2,049, dyadic 2: 16
    (9596, 9596, 8): "ckpt",       # length 2,400, dyadic 2: 5
    (9684, 12000, 8): "ckpt",      # 1.68 GB: 5 a chunk
    (9684, 13000, 8): "ckpt",      # 1.76 GB: 4 a chunk
    (9685, 20000, 8): "striped",
    (0, 20000, 8): "full",
}


@pytest.mark.parametrize("MM,NN,itemsize", sorted(_GEN_TIERS))
def test_resolve_inc_tier_at_the_generator_gate(MM, NN, itemsize):
    want = _GEN_TIERS[(MM, NN, itemsize)]
    for shape in ((MM, NN), (NN, MM)):
        assert routes.resolve_inc_tier(
            shape, itemsize, backward=True,
            min_pairs=routes.GEN_CKPT_MIN_PAIRS) == want


# the generators on the card, by refined shape, input dtype, grade and
# whether a gradient is wanted: (kernel, MM, NN, dtype, grade, need_grad)
# -> family. Every shape that chip_smoke.py's phases 2-9 run keeps the
# family it had before the long-path tier (first block).
_F = {"f64": torch.float64, "f32": torch.float32}
_GATED = {
    # phases 2, 4, 5 (north star, dyadic 1; with and without gradients)
    ("rbf", 2046, 2046, "f64", "auto", False): "gen",
    ("rbf", 2046, 2046, "f32", "auto", False): "gen",
    ("rbf", 2046, 2046, "f64", "auto", True): "gen",
    ("rbf", 2046, 2046, "f64", "f32", True): "gen",
    ("rbf", 2046, 2046, "f32", "auto", True): "gen",
    # phases 3, 6 (LinearKernel 50 x len 100, dyadic 0) and 4, 6 (batch
    # 32, len 200, dyadic 1)
    ("linear", 99, 99, "f64", "auto", False): "lgen",
    ("linear", 99, 99, "f32", "auto", True): "lgen",
    ("linear", 99, 99, "f64", "auto", True): "lgen",
    ("rbf", 398, 398, "f64", "auto", True): "gen",
    ("functional", 99, 99, "f64", "auto", False): "inc",
    # phase 8 (CHSIC, len 1024, dyadic 2, forward) and phase 9 (Linear at
    # the north star)
    ("rbf", 4092, 4092, "f64", "auto", False): "gen",
    ("linear", 2046, 2046, "f64", "auto", False): "lgen",
    ("linear", 2046, 2046, "f32", "auto", False): "lgen",
    # the long-path tier: the ckpt gates (the generator's, 64 full stacks a
    # chunk, which phase 12's size fails with 32 in double and passes with
    # 64 in float; Linear's backward is K2-stack -> K3<inc>, behind the gate
    # of 128) and the row bound
    ("rbf", 4092, 4092, "f64", "auto", True): "inc",
    ("rbf", 4092, 4092, "f64", "f32", True): "gen",
    ("rbf", 4092, 4092, "f32", "auto", True): "gen",
    ("rbf", 2044, 2044, "f64", "auto", True): "gen",    # 128 a chunk
    ("rbf", 2364, 2364, "f64", "auto", True): "gen",    # 96 a chunk
    ("rbf", 2892, 2892, "f64", "auto", True): "gen",    # 64 a chunk
    ("rbf", 2900, 2900, "f64", "auto", True): "inc",    # 63 a chunk
    ("rbf", 9596, 9596, "f64", "auto", True): "inc",    # 5 a chunk
    ("rbf", 9684, 13000, "f64", "auto", True): "inc",   # 4 a chunk
    ("rbf", 8192, 8192, "f32", "auto", True): "inc",    # 16 a chunk
    ("linear", 4092, 4092, "f64", "auto", True): "inc",
    ("linear", 2364, 2364, "f64", "auto", True): "inc",   # 96 a chunk
    ("linear", 2044, 2044, "f64", "auto", True): "lgen",  # 128 a chunk
    ("rbf", 20000, 20000, "f64", "auto", False): "inc",
    ("rbf", 20000, 20000, "f32", "auto", False): "inc",
    ("rbf", 20000, 20000, "f64", "f32", True): "inc",
    ("linear", 20000, 20000, "f64", "auto", False): "inc",
    ("rbf", 9685, 30000, "f64", "auto", False): "inc",
    ("rbf", 9685, 30000, "f32", "auto", False): "gen",
}


@pytest.mark.parametrize("kernel,MM,NN,dtype,grade,need_grad",
                         sorted(_GATED))
def test_resolve_family_gates_matrix(kernel, MM, NN, dtype, grade,
                                     need_grad):
    want = _GATED[(kernel, MM, NN, dtype, grade, need_grad)]
    for solver in ("auto", "cuda"):
        got = routes.resolve_family(
            _KERNELS[kernel], "cuda", solver, shape=(MM, NN),
            dtype=_F[dtype], grad_solver=grade, need_grad=need_grad)
        assert got == want
    # the plain tier ignores the shape
    assert routes.resolve_family(_KERNELS[kernel], "cpu", "auto",
                                 shape=(MM, NN), dtype=_F[dtype],
                                 need_grad=need_grad) == "scan"


# float32 sweeps past the float32 row bound warn on the card's routes:
# (MM, NN, dtype, grade, need_grad) -> warns
_F32_WARN = {
    (20000, 20000, "f32", "auto", False): True,    # phase 10, float32
    (20000, 20000, "f64", "f32", True): True,      # phase 11, f32 grade
    (20000, 20000, "f64", "f32", False): False,    # values in float64
    (20000, 20000, "f64", "auto", True): False,
    (19369, 30000, "f32", "auto", True): False,    # within the bound
    (2046, 2046, "f32", "f32", True): False,
}


@pytest.mark.parametrize("MM,NN,dtype,grade,need_grad", sorted(_F32_WARN))
def test_float32_long_grid_warns(MM, NN, dtype, grade, need_grad):
    import warnings

    for device in ("cuda", "cpu"):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            routes.resolve_family(_KERNELS["rbf"], device, "auto",
                                  shape=(MM, NN), dtype=_F[dtype],
                                  grad_solver=grade, need_grad=need_grad)
        warned = any(issubclass(w.category, RuntimeWarning)
                     and "drift far from float64" in str(w.message)
                     for w in seen)
        # the plain tier (CPU) never warns
        assert warned == (device == "cuda"
                          and _F32_WARN[(MM, NN, dtype, grade, need_grad)])


def test_import_pulls_in_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, sigkernel_tpu_torch, sigkernel_tpu_torch.ops.solve, "
            "sigkernel_tpu_torch.ops.cuda_gen, sigkernel_tpu_torch.stats, "
            "sigkernel_tpu_torch.ops.incvjp, sigkernel_tpu_torch.ops.cuda_deriv, "
            "sigkernel_tpu_torch.ops.cuda_lgen, "
            "sigkernel_tpu_torch.ops.cuda_blocked, "
            "sigkernel_tpu_torch.models.mmd_flow, "
            "sigkernel_tpu_torch.models.classifier, "
            "sigkernel_tpu_torch.transforms\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'sigkernel_tpu'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
