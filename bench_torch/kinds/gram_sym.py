"""``SigKernel(kernel, dyadic_order).compute_Gram(X, X, sym=True)``: the
pairs ``i <= j`` of ``X``."""
from bench_torch import reference as ref
from bench_torch import traffic as tf


def pairs(mix):
    n = mix["paths"]["X"]
    return n * (n + 1) // 2


def floats_out(mix, cfg):
    return mix["paths"]["X"] ** 2


def run(skt, cell, paths, dtype):
    x, p = tf.leaves(cell, paths, dtype)
    sk = skt.SigKernel(tf.program_kernel(skt, cell, p),
                       cell.config["dyadic_order"])
    return {"gram": sk.compute_Gram(x["X"], x["X"], sym=True,
                                    max_batch=cell.mix["max_batch"])}


def reference(cell, paths):
    return {"gram": ref.gram_sym(paths["X"], tf.reference_kernel(cell, paths),
                                 2 ** cell.config["dyadic_order"])}
