"""A library user's loop: the part is meshed and compiled once, in set-up
(`compile_problem`); then each request is a new load case on the compiled
problem and `CompiledProblem.solve()`, whose answer comes back as NumPy
arrays on the host.

The new load case reaches the compiled problem by `dataclasses.replace`
of its `u_value` and `f_value` (harness/inputs.LoadCaseFields); the
supports, and with them the operator and the preconditioner, stay."""

from __future__ import annotations

from benchmark.harness import inputs
from benchmark.harness.core import Answer


class Session:
    def __init__(self, env):
        from magnetite_tpu_torch.fem.solve import compile_problem

        cfg = env.config
        self.env = env
        self.mesh = inputs.make_mesh(cfg)
        bca = inputs.boundary_arrays(cfg, self.mesh.coords, env.warm_up_case(0))
        self.problem = compile_problem(
            self.mesh, bca, inputs.metadata(cfg), inputs.solver_options(cfg, env.control),
            device=env.device,
        )
        self.fields = inputs.LoadCaseFields(cfg, self.mesh.coords, self.problem)

    def request(self, load_case) -> Answer:
        with self.env.span("load_case"):
            problem = self.fields.apply(load_case)
        with self.env.span("solve"):
            res = problem.solve()
        return Answer(
            self.mesh.coords, self.mesh.tris, res.u, res.f, res.sigma, res.stress,
            res.von_mises, readings=inputs.readings_of(res),
        )

    def shapes(self) -> dict:
        return inputs.shapes_of(self.problem)

    def close(self):
        self.problem = self.fields = None
