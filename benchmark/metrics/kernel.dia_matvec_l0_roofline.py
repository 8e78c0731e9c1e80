"""kernel.dia_matvec_l0_roofline: the level-0 operator applications'
share of their bound, in percent.

Calls: `dia_matvec_kernel<T, 2>` (the node-dof banded operator; the
coarse AMG levels run `dia_matvec_slices_kernel` and are not counted) and,
where the double-float matvec is on, `df_dia_matvec_kernel`. Each call,
from the operator's shape (D bands, N nodes) and its value type: the
bands D x 2 x 2 x N and the input vector 2 x N read once, the output 2 x N
written once, the D offsets (int32) read once; 2 flops a band value. The
double-float call reads hi / lo float32 band pairs (8 bytes a value) and
float64 vectors. Bound: harness/yardstick.py. Share: the calls' bounds
over their profiled time. None where the trace holds no such call."""

import re

from benchmark.harness import yardstick as ys

LEVEL0 = re.compile(r"\bdia_matvec_kernel<\s*(float|double)\s*,\s*2\s*>")
DOUBLE_FLOAT = re.compile(r"\bdf_dia_matvec_kernel\b")


def call_bytes(value_size: int, vector_size: int, n_diags: int, n: int) -> int:
    return n_diags * 4 * n * value_size + 2 * 2 * n * vector_size + 4 * n_diags


def read(ctx):
    shape = ctx.shapes.get("dia_level0")
    if ctx.trace is None or not shape:
        return None
    d, n = shape["n_diags"], shape["n"]
    bound = spent = 0.0
    for name, seconds in ctx.trace.kernels:
        m = LEVEL0.search(name)
        if m:
            size = ys.ITEMSIZE[m.group(1)]
            bound += ys.bound_s(call_bytes(size, size, d, n), 2.0 * d * 4 * n, m.group(1))
        elif DOUBLE_FLOAT.search(name):
            bound += ys.bound_s(call_bytes(8, 8, d, n), 0.0, "float")
        else:
            continue
        spent += seconds
    return 100.0 * bound / spent if spent > 0 else None
