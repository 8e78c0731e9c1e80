"""host_prep.compile_s: seconds of `compile_problem` per job (structure,
renumbering, assembly, the preconditioner's host build, the upload), the
program's root span of the compile, its total over its count in the
traced stretch. It times the compile apart from the mesh and the solve."""

from benchmark.harness import spans


def read(ctx):
    compile_span = (spans.totals() or {}).get("compile_problem")
    if not compile_span or not compile_span["count"]:
        return None
    return compile_span["total_s"] / compile_span["count"]
