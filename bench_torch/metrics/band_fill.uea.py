"""band_fill.uea: the share of the band kernels' lanes that hold a row of a
frame, in %: 100 x ``rows`` / ``slots`` of the program's counter
``cuda_gen.BAND_FILL`` (refined rows solved, and bands' rows launched, 128
a band), summed over every band launch of the run: the warm call's and the
window's, which solve the same shapes. None untraced, on a program without
the counter, or with no band launch."""


def read(run):
    if not run.trace or not run.library:
        return None
    from sigkernel_tpu_torch.ops import cuda_gen

    fill = getattr(cuda_gen, "BAND_FILL", None)
    if not fill or not fill.get("slots"):
        return None
    return 100.0 * fill["rows"] / fill["slots"]
