"""The CLI user's job, without the CSV: each request meshes the part's
outline (`triangulate`), applies the supports and the load case
(`apply_boundary_conditions`), compiles (`compile_problem`: structure,
renumbering, assembly, the AMG build, the upload) and solves, and the
answer comes back as NumPy arrays on the host. Nothing is kept from one
job to the next."""

from __future__ import annotations

import time

from benchmark.harness import inputs
from benchmark.harness.core import Answer


class Session:
    def __init__(self, env):
        self.env = env
        self.last_shapes = {}

    def request(self, load_case) -> Answer:
        from magnetite_tpu_torch.fem.solve import compile_problem

        cfg = self.env.config
        span = self.env.span
        t0 = time.perf_counter()
        with span("mesh"):
            mesh = inputs.make_mesh(cfg)
        mesh_s = time.perf_counter() - t0
        with span("supports"):
            bca = inputs.boundary_arrays(cfg, mesh.coords, load_case)
        with span("compile_problem"):
            problem = compile_problem(
                mesh, bca, inputs.metadata(cfg), inputs.solver_options(cfg, self.env.control),
                device=self.env.device,
            )
        with span("solve"):
            res = problem.solve()
        self.last_shapes = inputs.shapes_of(problem)
        return Answer(mesh.coords, mesh.tris, res.u, res.f, res.sigma, res.stress,
                      res.von_mises, readings=inputs.readings_of(res, mesh_s=mesh_s))

    def shapes(self) -> dict:
        return self.last_shapes

    def close(self):
        pass
