"""``sig_scoring_rule(kernel, X, y)`` and ``.backward()``: the pairs ``i <
j`` of ``X`` and every pair of ``X`` and ``y``."""
from bench_torch import reference as ref
from bench_torch import traffic as tf


def pairs(mix):
    n, m = mix["paths"]["X"], mix["paths"]["y"]
    return n * (n + 1) // 2 + n * m


def floats_out(mix, cfg):
    return 1 + tf.grad_floats(mix, cfg)


def run(skt, cell, paths, dtype):
    mix, cfg = cell.mix, cell.config
    x, p = tf.leaves(cell, paths, dtype)
    v = skt.sig_scoring_rule(
        tf.program_kernel(skt, cell, p), x["X"], x["y"],
        dyadic_order=cfg["dyadic_order"], max_batch=mix["max_batch"],
        grad_solver=cfg["grad_solver"], pair_chunk=mix["pair_chunk"])
    v.backward()
    return {"value": v.detach(), **tf.grads(cell, x, p)}


def reference(cell, paths):
    v, dX, _, dp = ref.scoring_rule_grads(
        paths["X"], paths["y"], tf.reference_kernel(cell, paths),
        2 ** cell.config["dyadic_order"])
    return tf.pick(cell, {"value": v, "dX": dX, f"d{cell.static.PARAM}": dp})
