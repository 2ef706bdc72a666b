"""The program's spans (``sigkernel_tpu_torch.tracing``) on CPU tensors.

With no profiler recording, no span is created. Under ``torch.profiler``
each estimator, and ``transform``, opens ``sk.est.<function>``, one
``sk.est.chunk`` a pass of its pair-chunk loop, ``sk.grid`` around each
increment grid built in PyTorch (``RBFKernel``'s on the ``inc`` family are
K9's, ``sk.op.rbf_gen_increments``) and ``sk.op.<kernel>`` around each
launching entry of ``ops/`` its route takes, each inside its parent in
time; host reads go through ``tracing.host`` (``sk.sync.<site>``). The
routes are steered onto the card's families by patching
``routes.resolve_family``, as the other CPU tests of those families do:
their Functions then run the plain versions behind the same entries. No
launch table is added to ``ops/``, so the benchmark's launch count reads
what it read before."""
import importlib
import math
import pkgutil

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import sigkernel_tpu_torch as skt
import sigkernel_tpu_torch.ops as ops
from sigkernel_tpu_torch import tracing
from sigkernel_tpu_torch.ops import routes

DT = torch.float64


def _paths(seed, batch, length, dim=2):
    g = torch.Generator().manual_seed(seed)
    steps = 0.6 * torch.randn(batch, length, dim, generator=g, dtype=DT)
    return torch.cumsum(steps / math.sqrt(length), dim=1)


@pytest.fixture
def steer(monkeypatch):
    """``steer("gen")``: RBF tiles take the generator's family; ``steer
    ("ckpt")``: every tile takes the ``inc`` family with the sparse adjoint
    (K2-sparse -> K8), its grids chunked three pairs at a time."""
    orig = routes.resolve_family

    def to(family):
        def steered(static_kernel, device_type, solver, **gates):
            if solver == "scan":
                return orig(static_kernel, device_type, solver, **gates)
            return "gen" if family == "gen" else "inc"

        monkeypatch.setattr(routes, "resolve_family", steered)
        if family == "ckpt":
            monkeypatch.setattr(routes, "CKPT_MIN_PAIRS", 1 << 40)
            monkeypatch.setattr(routes, "STACK_BYTES",
                                3 * routes.grid_bytes(5, 5, 8))
    return to


def lincomb():
    """``sig_gram_lincomb`` of 3 x 4 paths, 5 pairs a chunk, fwd + bwd in
    X, Y, W and sigma on the generator's family: 3 chunks."""
    X = _paths(1, 3, 6).requires_grad_()
    Y = _paths(2, 4, 6).requires_grad_()
    W = torch.randn(3, 4, generator=torch.Generator().manual_seed(3),
                    dtype=DT).requires_grad_()
    sigma = torch.tensor(0.7, dtype=DT, requires_grad=True)
    S = skt.sig_gram_lincomb(skt.RBFKernel(sigma), X, Y, W, dyadic_order=1,
                             pair_chunk=5)
    S.backward()


def scoring():
    """``sig_scoring_rule`` of 4 paths against 1, fwd + bwd in X and sigma
    on the ``inc`` family's sparse adjoint: the sym Gram's 10 pairs in 4
    grid chunks, the 4 pairs against ``y`` in 2, each built by K9 and built
    again in the backward, whose cotangent K4 carries to X and sigma."""
    X = _paths(4, 4, 6).requires_grad_()
    y = _paths(5, 1, 6)
    sigma = torch.tensor(0.7, dtype=DT, requires_grad=True)
    skt.sig_scoring_rule(skt.RBFKernel(sigma), X, y,
                         dyadic_order=1).backward()


def gram_sym():
    """``sig_gram(sym=True)`` of 4 paths, 4 pairs a chunk, on the
    generator's family: the 10 pairs of the triangle in 3 chunks."""
    skt.sig_gram(skt.RBFKernel(0.7), _paths(6, 4, 6), _paths(6, 4, 6),
                 dyadic_order=1, sym=True, max_batch=2)


def transform():
    """``transform`` of 3 paths with lead-lag and add-time: its span alone,
    with nothing under it."""
    skt.transform(_paths(10, 3, 6), at=True, ll=True, scale=0.1)


# each call: its family, estimator, chunk spans directly inside the
# estimator's, whether it builds grids in PyTorch, and its sk.op entries
CALLS = {
    "lincomb": (lincomb, "gen", "sig_gram_lincomb", 3, False,
                {"rbf_gen_stack", "adjoint_collapse_gen", "rbf_dd_vjp"}),
    "scoring": (scoring, "ckpt", "sig_scoring_rule", 0, False,
                {"rbf_gen_increments", "inc_wavefront",
                 "inc_wavefront[sparse]", "adjoint_ckpt", "rbf_dd_vjp"}),
    "gram_sym": (gram_sym, "gen", "sig_gram", 3, False,
                 {"rbf_gen_wavefront"}),
    "transform": (transform, "gen", "transform", 0, False, set()),
}


class Counting:
    """Stands in for ``record_function`` and counts its constructions."""
    made = 0

    def __init__(self, name, *args):
        Counting.made += 1
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.fixture
def counting(monkeypatch):
    Counting.made = 0
    for mod in (torch.autograd.profiler, torch.profiler):
        monkeypatch.setattr(mod, "record_function", Counting)
    return Counting


def spans(fn):
    """The ``sk.`` spans ``fn()`` opens under the profiler, as ``(name,
    start ns, end ns)`` in order of start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith("sk.")]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def parent(s, every):
    """The innermost other span of ``every`` around ``s`` in time, or
    ``None``."""
    around = [p for p in every if p is not s and p[1] <= s[1]
              and s[2] <= p[2]]
    return min(around, key=lambda p: p[2] - p[1], default=None)


@pytest.mark.parametrize("call", sorted(CALLS))
def test_no_span_is_made_while_no_profiler_records(steer, counting, call):
    fn, family = CALLS[call][:2]
    steer(family)
    fn()
    assert counting.made == 0
    assert tracing.span("sk.est.chunk") is tracing.span("sk.grid")


@pytest.mark.parametrize("call", sorted(CALLS))
def test_spans_under_the_profiler_nest_by_layer(steer, call):
    fn, family, est, chunks, grids, kernels = CALLS[call]
    steer(family)
    got = spans(fn)
    names = [s[0] for s in got]
    top = [s for s in got if s[0] == f"sk.est.{est}"]
    assert len(top) == 1
    top = top[0]
    assert parent(top, got) is None
    assert sum(parent(s, got) is top for s in got
               if s[0] == "sk.est.chunk") == chunks
    assert ("sk.grid" in names) == grids
    assert {n[len("sk.op."):] for n in names
            if n.startswith("sk.op.")} == kernels
    for s in got:
        up = parent(s, got)
        up = up[0] if up else None
        if s[0].startswith("sk.op.") or s[0] == "sk.grid":
            assert up in ("sk.est.chunk", "sk.est.tile"), (s, up)
        elif s[0].startswith("sk.sync."):
            assert up is not None and up.startswith("sk.op."), (s, up)
        elif s[0] in ("sk.est.chunk", "sk.est.tile") and s[1] < top[2]:
            # the forward's passes lie inside the estimator's call
            assert up is not None and up.startswith("sk.est."), (s, up)


def test_the_backward_rebuilds_each_grid_chunk(steer):
    """The scoring rule's grids, 4 + 2 chunks, are built once in the
    forward and once more in the backward (K9), each inside its own chunk,
    and each backward chunk's cotangent goes to X and sigma by K4."""
    steer("ckpt")
    got = spans(scoring)
    est = next(s for s in got if s[0] == "sk.est.sig_scoring_rule")
    grids = [s for s in got if s[0] == "sk.op.rbf_gen_increments"]
    assert sum(g[1] < est[2] for g in grids) == 6
    assert sum(g[1] > est[2] for g in grids) == 6
    vjps = [s for s in got if s[0] == "sk.op.rbf_dd_vjp"]
    assert len(vjps) == 6 and all(s[1] > est[2] for s in vjps)
    for g in grids + vjps:
        assert parent(g, got)[0] == "sk.est.chunk"
    # the adjoint's chunks (one pair's sparse stack each) inside the grid's
    adjoint = [s for s in got if s[0] in ("sk.op.inc_wavefront[sparse]",
                                          "sk.op.adjoint_ckpt")
               and s[1] > est[2]]
    assert len(adjoint) == 2 * (10 + 4)
    for s in adjoint:
        up = parent(s, got)
        assert up[0] == "sk.est.chunk" and parent(up, got)[0] == "sk.est.chunk"


@pytest.mark.parametrize("est", [
    "sig_kernel", "sig_gram", "sig_gram_lincomb", "sig_scoring_rule",
    "sig_expected_scoring_rule", "sig_mmd", "sig_distance",
    "sig_kernel_and_derivatives_gram", "sig_chsic"])
def test_every_public_estimator_opens_its_span(est):
    X, Y = _paths(7, 3, 5), _paths(8, 3, 5)
    k = skt.RBFKernel(0.5)
    call = {
        "sig_kernel": lambda: skt.sig_kernel(k, X, Y),
        "sig_gram": lambda: skt.sig_gram(k, X, Y),
        "sig_gram_lincomb": lambda: skt.sig_gram_lincomb(
            k, X, Y, torch.ones(3, 3, dtype=DT)),
        "sig_scoring_rule": lambda: skt.sig_scoring_rule(k, X, Y[:1]),
        "sig_expected_scoring_rule": lambda: skt.sig_expected_scoring_rule(
            k, X, Y),
        "sig_mmd": lambda: skt.sig_mmd(k, X, Y),
        "sig_distance": lambda: skt.sig_distance(k, X, Y),
        "sig_kernel_and_derivatives_gram": lambda:
            skt.sig_kernel_and_derivatives_gram(k, X, Y, torch.ones_like(X)),
        "sig_chsic": lambda: skt.sig_chsic(X, Y, _paths(9, 3, 5), k),
    }[est]
    names = [s[0] for s in spans(call)]
    assert f"sk.est.{est}" in names
    # every estimator builds its grids on the plain tier
    assert "sk.grid" in names
    if est == "sig_chsic":
        assert names.count("sk.sync.cholesky") == 1
    if est == "sig_kernel_and_derivatives_gram":
        assert "sk.est.tile" in names


@pytest.mark.parametrize("value", [
    torch.tensor(0.25, dtype=DT), torch.tensor([3, -1, 7]),
    torch.tensor(True)])
def test_host_reads_as_tolist_and_marks_only_while_profiling(counting,
                                                             value):
    assert tracing.host(value, "probe") == value.tolist()
    assert counting.made == 0


def test_host_opens_its_sync_span_while_profiling():
    t = torch.tensor([1.5, 2.5])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = tracing.host(t, "probe")
    assert got == [1.5, 2.5]
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("sk.sync.probe") == 1


def test_spanned_keeps_the_function(counting):
    @tracing.spanned("sk.est.probe")
    def f(a, b=2):
        """Doc."""
        return a + b

    assert (f(1), f(1, b=5), f.__name__, f.__doc__) == (3, 6, "f", "Doc.")
    assert counting.made == 0


def _counts():
    """Every ``*COUNTS`` table of ``ops/`` by module and name."""
    out = {}
    for info in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"{ops.__name__}.{info.name}")
        for name, table in vars(mod).items():
            if name.endswith("COUNTS") and isinstance(table, dict):
                out[f"{info.name}.{name}"] = dict(table)
    return out


def test_no_launch_table_is_added():
    assert set(_counts()) == {
        "cuda_blocked.COUNTS", "cuda_blocked.STACK_COUNTS",
        "cuda_blocked.ADJOINT_COUNTS", "cuda_deriv.COUNTS",
        "cuda_gen.COUNTS", "cuda_gen.STACK_COUNTS", "cuda_gen.ADJOINT_COUNTS",
        "cuda_gen.INCREMENT_COUNTS", "cuda_lgen.COUNTS", "cuda_solver.COUNTS", "cuda_solver.STACK_COUNTS",
        "cuda_solver.ADJOINT_COUNTS", "cuda_solver.SPARSE_COUNTS",
        "cuda_solver.CKPT_COUNTS", "incvjp.COUNTS"}
    assert not any(n.endswith("COUNTS") for n in vars(tracing))


def test_tracing_leaves_the_launch_counts_alone(steer):
    """A traced call counts the same launches as an untraced one."""
    steer("gen")

    def delta(fn):
        before = _counts()
        fn()
        after = _counts()
        return {k: {c: after[k][c] - before[k][c] for c in after[k]}
                for k in after}

    plain = delta(lincomb)
    assert delta(lambda: spans(lincomb)) == plain
    assert any(any(d.values()) for d in plain.values())
