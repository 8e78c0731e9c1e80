"""host_prep.mesh_s: seconds of meshing per job, the benchmark's own host
clock around `triangulate`, the mean over the window's jobs."""


def read(ctx):
    vals = [r["mesh_s"] for r in ctx.readings if "mesh_s" in r]
    return sum(vals) / len(vals) if vals else None
