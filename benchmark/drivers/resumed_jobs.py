"""The `--load-case` user's job: set-up prepares the part once, fresh, and
saves its case, its AMG hierarchy and its assembled operator
(`persist.save_case` / `save_amg` / `save_operator`) into a directory
under TMPDIR. Each request loads the three (`load_case`, `load_amg`,
`load_operator`), applies the load case's supports and loads to the
loaded mesh, compiles from the caches (`compile_problem(...,
amg_setup=, operator_cache=)`) and solves; the answer comes back as NumPy
arrays on the host. The directory is deleted when the run closes."""

from __future__ import annotations

import os
import shutil
import tempfile
import time

from benchmark.harness import inputs
from benchmark.harness.core import Answer


class Session:
    def __init__(self, env):
        self.env = env
        self.last_shapes = {}
        self.dir = tempfile.mkdtemp(prefix="bench_case_")
        self.case = os.path.join(self.dir, "case.npz")
        try:
            self._prepare(env.config)
        except BaseException:
            self.close()
            raise

    def _prepare(self, cfg):
        """One fresh prep of the part, saved as the `--load-case` user has it."""
        from magnetite_tpu_torch import persist
        from magnetite_tpu_torch.fem.solve import compile_problem

        env = self.env
        mesh = inputs.make_mesh(cfg)
        bca = inputs.boundary_arrays(cfg, mesh.coords, env.warm_up_case(0))
        md = inputs.metadata(cfg)
        problem = compile_problem(
            mesh, bca, md, inputs.solver_options(cfg, env.control, keep_operator_host=True),
            device=env.device,
        )
        persist.save_case(self.case, mesh, bca, metadata=md)
        persist.save_amg(self.case + ".amg.npz", problem.amg_setup)
        persist.save_operator(self.case + ".op.npz", problem)

    def request(self, load_case) -> Answer:
        from magnetite_tpu_torch import persist
        from magnetite_tpu_torch.fem.solve import compile_problem

        cfg = self.env.config
        span = self.env.span
        t0 = time.perf_counter()
        with span("persist.load"):
            mesh, _, md, structure = persist.load_case(self.case)
            amg = persist.load_amg(self.case + ".amg.npz")
            operator = persist.load_operator(self.case + ".op.npz")
        load_s = time.perf_counter() - t0
        with span("supports"):
            bca = inputs.boundary_arrays(cfg, mesh.coords, load_case)
        with span("compile_problem"):
            problem = compile_problem(
                mesh, bca, md, inputs.solver_options(cfg, self.env.control),
                structure=structure, amg_setup=amg, operator_cache=operator,
                device=self.env.device,
            )
        if problem.timings.get("operator_cache") != "hit" or problem.amg_setup is not amg:
            raise RuntimeError("the resumed compile did not take the saved operator and AMG")
        with span("solve"):
            res = problem.solve()
        self.last_shapes = inputs.shapes_of(problem)
        return Answer(mesh.coords, mesh.tris, res.u, res.f, res.sigma, res.stress,
                      res.von_mises, readings=inputs.readings_of(res, load_s=load_s))

    def shapes(self) -> dict:
        return self.last_shapes

    def close(self):
        shutil.rmtree(self.dir, ignore_errors=True)
