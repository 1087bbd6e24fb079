"""cholesky_roofline_pct: the least time of the dense factorisation that a
pose graph's LM trial needs, D^3/3 operations for D = 6 x the input's
poses at the card's float64 tensor-core peak (the bound: its bytes at the
HBM peak take ~5% of that), over the mean device time of what each
``aten::linalg_cholesky_ex`` launched in the traced stretch."""

from portbench.roofline import (H100_SXM, cholesky_bytes, cholesky_flops,
                                least_seconds)

OP = "aten::linalg_cholesky_ex"


def read(ctx):
    tr = ctx["trace"]
    op = (tr or {}).get("host_ops", {}).get(OP)
    if not op or not op["count"] or op["device_s"] <= 0:
        return None
    d = 6 * ctx["config"]["n_poses"]
    least = least_seconds(cholesky_flops(d), cholesky_bytes(d),
                          H100_SXM["fp64_tensor_flops"])
    return 100.0 * least / (op["device_s"] / op["count"])
