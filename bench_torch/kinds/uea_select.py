"""One model-selection pass of the UEA classification example: for each
transform of the configuration (``transforms``: add-time, lead-lag) the
train paths ``X`` and test paths ``T`` are transformed on the card
(``transform(paths, at, ll, scale)``), and for each of its ``sigmas`` a
``SigKernelSVC(RBFKernel(sigma), dyadic_order, max_batch=...)`` computes the
train paths' symmetric Gram and the test paths' Gram against them, ``sigma``
a Python number as in the example. The SVC's quadratic program (host
sklearn) is not part of the call.

The mix names the pass's ``grid_points``, the (transform, sigma) pairs it
runs, which must be the configuration's; the outputs are, for each
transform, the stacks ``train_<tag>`` ``(sigmas, n, n)`` and ``test_<tag>``
``(sigmas, m, n)``, ``tag`` ``at``, ``ll`` or ``atll``."""
import torch

from bench_torch import reference as ref
from bench_torch import transforms_ref


def pairs(mix):
    n, m = mix["paths"]["X"], mix["paths"]["T"]
    return mix["grid_points"] * (n * (n + 1) // 2 + m * n)


def floats_out(mix, cfg):
    n, m = mix["paths"]["X"], mix["paths"]["T"]
    return mix["grid_points"] * (n * n + m * n)


def tag(t):
    return ("at" if t.get("at") else "") + ("ll" if t.get("ll") else "")


def _opts(cfg, t):
    return dict(at=bool(t.get("at")), ll=bool(t.get("ll")),
                scale=cfg["scale"])


def shapes(cfg):
    """``(tag, length, dim)`` of the paths each transform makes."""
    L, D = cfg["length"], cfg["dim"]
    out = []
    for t in cfg["transforms"]:
        ll = bool(t.get("ll"))
        out.append((tag(t), 2 * L - 1 if ll else L,
                    (2 * D if ll else D) + bool(t.get("at"))))
    return out


def _grid(cfg, mix):
    if len(cfg["transforms"]) * len(cfg["sigmas"]) != mix["grid_points"]:
        raise ValueError("the mix's grid_points is not the configuration's "
                         "transforms times its sigmas")


def run(skt, cell, paths, dtype):
    cfg = cell.config
    _grid(cfg, cell.mix)
    X, T = paths["X"].to(dtype), paths["T"].to(dtype)
    kernel = getattr(skt, cfg["static_kernel"])
    out = {}
    for t in cfg["transforms"]:
        x, y = (skt.transform(P, **_opts(cfg, t)) for P in (X, T))
        train, test = [], []
        for s in cfg["sigmas"]:
            svc = skt.models.SigKernelSVC(kernel(s), cfg["dyadic_order"],
                                          max_batch=cfg["max_batch"])
            train.append(svc.train_gram(x))
            test.append(svc.test_gram(y))
        out[f"train_{tag(t)}"] = torch.stack(train)
        out[f"test_{tag(t)}"] = torch.stack(test)
    return out


# pairs whose point distances are built at a time
SUB_PAIRS = 1024


def _values(cell, x, y, ii, jj, f):
    """``k_sigma(x[ii[p]], y[jj[p]])`` of every pair at every sigma of the
    configuration, ``(sigmas, P)``, in blocks of pairs: a block's point
    distances once, by the static kernel's ``gram`` (its ``dist``), then at
    each sigma its values ``exp(-dist / sigma)``, their double difference
    and the reference's sweep."""
    sigmas = cell.config["sigmas"]
    P, M, N = ii.shape[0], x.shape[1], y.shape[1]
    # the distances, a sigma's values, the increments and their temporaries
    per = x.element_size() * (2 * M * N + 5 * (M - 1) * (N - 1))
    B = max(1, ref._budget(x.device) // per)
    kern = cell.static.Kernel(x.new_tensor(sigmas[0]))
    out = x.new_empty(len(sigmas), P)
    for s in range(0, P, B):
        i, j = ii[s:s + B], jj[s:s + B]
        dist = torch.cat([kern.gram(x[i[t:t + SUB_PAIRS]],
                                    y[j[t:t + SUB_PAIRS]])[1]
                          for t in range(0, i.shape[0], SUB_PAIRS)])
        for k, sigma in enumerate(sigmas):
            G = torch.exp(-dist / sigma)
            inc = ref._double_difference(G).permute(1, 2, 0).contiguous()
            del G
            out[k, s:s + B] = ref.sweep_values(inc, f)
            del inc
        del dist
    return out


def reference(cell, paths):
    """Both Grams of every (transform, sigma) in float64, through the
    reference's transforms and sweep."""
    cfg = cell.config
    f = 2 ** cfg["dyadic_order"]
    out = {}
    for t in cfg["transforms"]:
        x, y = (transforms_ref.transform(paths[k], **_opts(cfg, t))
                for k in ("X", "T"))
        n, m = x.shape[0], y.shape[0]
        iu, ju = ref.sym_pairs(n, x.device)
        upper = _values(cell, x, x, iu, ju, f)
        train = x.new_zeros(len(cfg["sigmas"]), n, n)
        train[:, iu, ju] = upper
        train[:, ju, iu] = upper
        ii = torch.arange(m, device=x.device).repeat_interleave(n)
        jj = torch.arange(n, device=x.device).repeat(m)
        out[f"train_{tag(t)}"] = train
        out[f"test_{tag(t)}"] = _values(cell, y, x, ii, jj, f).reshape(
            -1, m, n)
    return out
