"""Matplotlib result plotting (in-process; no subprocess round-trip).

The reference shells out to ``python scripts/plot.py nodes.csv elements.csv
cmap`` (src/post_processor.rs:90-123, scripts/plot.py) and deletes the CSVs
afterwards. Here plotting is an in-process library call on the in-memory
arrays -- no CSV round-trip, no fragile repo-root path resolution -- with the
same visual layout: "Initial Model" (undeformed, gray) and "Solved Model"
(deformed by u, stress-colored with the chosen cmap), subplot orientation
picked by the model's aspect ratio vs 16:9, shared axis limits, equal aspect.
"""

from __future__ import annotations


from ..errors import PostProcessorError
from ..fem.solve import SolveResult
from ..meshing.core import Mesh


def plot_results(
    mesh: Mesh,
    result: SolveResult,
    cmap: str = "coolwarm",
    show: bool = True,
    save_path: str | None = None,
):
    """Render the initial vs solved model figure. Returns the figure."""
    try:
        import matplotlib

        if not show:
            matplotlib.use("Agg")
        from matplotlib import pyplot as plt
        from matplotlib.collections import PolyCollection
        import matplotlib.colors as mcolors
    except ImportError as err:
        raise PostProcessorError(f"matplotlib unavailable: {err}")

    coords = mesh.coords
    tris = mesh.tris
    stress = result.stress

    x_range = coords[:, 0].max() - coords[:, 0].min()
    y_range = coords[:, 1].max() - coords[:, 1].min()
    shape = (2, 1) if x_range / 16 > y_range / 9 else (1, 2)

    try:
        plt.style.use("seaborn-v0_8")
    except OSError:
        pass
    fig, axs = plt.subplots(*shape)
    fig.suptitle("Simulation Results")
    solved_ax, initial_ax = axs[0], axs[1]

    initial_tris = coords[tris]  # [E,3,2]
    initial_ax.add_collection(
        PolyCollection(
            initial_tris,
            facecolors="#4C4C4C",
            edgecolors="black",
            linewidths=0.2,
            alpha=0.7,
        )
    )
    initial_ax.set_title("Initial Model")

    deformed = (coords + result.u)[tris]
    norm = mcolors.Normalize(vmin=float(stress.min()), vmax=float(stress.max()))
    colors = plt.get_cmap(cmap)(norm(stress))
    solved_ax.add_collection(
        PolyCollection(
            deformed,
            facecolors=colors,
            edgecolors="black",
            linewidths=0.2,
            alpha=0.7,
        )
    )
    solved_ax.set_title("Solved Model")

    for ax in (solved_ax, initial_ax):
        ax.autoscale()
    # share the wider limits so both subplots frame the same region
    xlim = (
        min(solved_ax.get_xlim()[0], initial_ax.get_xlim()[0]),
        max(solved_ax.get_xlim()[1], initial_ax.get_xlim()[1]),
    )
    ylim = (
        min(solved_ax.get_ylim()[0], initial_ax.get_ylim()[0]),
        max(solved_ax.get_ylim()[1], initial_ax.get_ylim()[1]),
    )
    for ax in (solved_ax, initial_ax):
        ax.set_xlim(xlim)
        ax.set_ylim(ylim)
        ax.set_aspect("equal", adjustable="box")
    fig.tight_layout(pad=2.0)

    if save_path is not None:
        fig.savefig(save_path, dpi=150)
    if show:
        plt.show()
    return fig
