"""``sig_chsic(X, Y, Z, kernel)``: three symmetric Grams, the pairs ``i <=
j`` of each, and the statistic."""
from bench_torch import reference as ref
from bench_torch import traffic as tf


def pairs(mix):
    return sum(n * (n + 1) // 2 for n in mix["paths"].values())


def floats_out(mix, cfg):
    return 1


def run(skt, cell, paths, dtype):
    mix = cell.mix
    x, p = tf.leaves(cell, paths, dtype)
    v = skt.sig_chsic(x["X"], x["Y"], x["Z"], tf.program_kernel(skt, cell, p),
                      dyadic_order=cell.config["dyadic_order"], eps=mix["eps"],
                      max_batch=mix["max_batch"])
    return {"value": v}


def reference(cell, paths):
    return {"value": ref.chsic(paths["X"], paths["Y"], paths["Z"],
                               tf.reference_kernel(cell, paths),
                               2 ** cell.config["dyadic_order"],
                               cell.mix["eps"])}
