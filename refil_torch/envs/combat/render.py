"""Host-side renderer for the combat envs, a copy of
``refil_tpu/envs/combat/render.py`` (reference ``starcraft2custom.py:1560-1633``:
matplotlib circles, facing arrows, health and shield bars).

A recording rollout (``VectorRunner.run(..., record=True)``) keeps each
step's ``render_state`` and render extras as numpy arrays; frames are drawn
here afterwards. Everything takes numpy inputs. ``render_frame`` needs
matplotlib and ``save_video`` imageio, both imported when called;
``save_replay`` needs numpy only.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from . import units as U

_ALLY_COLORS = ["#2e7dd1", "#1fa774", "#7d5fd3", "#2aa8b8", "#4666d1"]
_ENEMY_COLORS = ["#d14b4b", "#d1812e", "#b83a70", "#a0522d", "#c2352f"]


def render_frame(rs: Dict[str, np.ndarray], b: int, map_size: float,
                 dpi: int = 48, size: float = 8.0,
                 geometry=None) -> np.ndarray:
    """Draw one env (batch element ``b``) of one recorded step. Returns an
    RGB uint8 array. Mirrors reference ``render:1560-1633``: unit circles,
    facing arrows, outlined health/shield bars, red attack/heal lines scaled
    by the cooldown ratio; plus terrain height / walkability shading for the
    geometry-defined maps (``geometry=(walkable, height)`` grids)."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure
    import matplotlib.patches as mp
    import matplotlib.lines as ml

    fig = Figure(figsize=(size, size), dpi=dpi)
    canvas = FigureCanvasAgg(fig)
    ax = fig.gca()
    ax.set_xlim(0, map_size)
    ax.set_ylim(0, map_size)
    ax.axis("off")

    if geometry is not None:
        walk, height = geometry
        # height shading (light=high); unwalkable cells drawn dark.
        # grids are indexed [x, y] -> transpose for imshow's (row=y, col=x)
        img = 0.55 + 0.4 * np.asarray(height, np.float32)
        img = np.where(np.asarray(walk, bool), img, 0.25)
        ax.imshow(
            img.T, origin="lower", extent=(0, walk.shape[0], 0, walk.shape[1]),
            cmap="gray", vmin=0.0, vmax=1.0, zorder=0.0,
        )

    pos = rs["pos"][b]
    health = rs["health"][b]
    shield = rs["shield"][b]
    hmax = rs["health_max"][b]
    smax = rs["shield_max"][b]
    types = rs["type"][b]
    active = rs["active"][b]
    is_ally = rs["is_ally"][b]
    target = rs.get("target")
    facing = rs.get("facing")
    facing_valid = rs.get("facing_valid")
    cd_ratio = rs.get("cd_ratio")

    for i in range(pos.shape[0]):
        if not active[i] or health[i] <= 0:
            continue
        t = int(types[i])
        color = (
            _ALLY_COLORS[t % len(_ALLY_COLORS)]
            if is_ally[i]
            else _ENEMY_COLORS[t % len(_ENEMY_COLORS)]
        )
        r = 0.4 + 0.08 * np.sqrt(hmax[i])
        ax.add_patch(
            mp.Circle(pos[i], r, linewidth=2, edgecolor="black",
                      facecolor=color, zorder=1.0)
        )
        # facing arrow (reference :1586-1590; skipped for Colossus there
        # because the engine reports none — we skip when this step gave no
        # direction, e.g. stop/no-op)
        if (
            facing is not None
            and facing_valid is not None
            and facing_valid[b][i]
            and "Colossus" not in U.UNIT_NAMES[t]
        ):
            dx, dy = r * np.cos(facing[b][i]), r * np.sin(facing[b][i])
            ax.arrow(pos[i, 0], pos[i, 1], dx, dy, linewidth=3, zorder=1.4)
        # outlined health/shield bars (reference :1592-1611)
        ax.add_patch(
            mp.Rectangle((pos[i, 0] - r, pos[i, 1] + r), 2 * r, 0.3,
                         linewidth=1, edgecolor="black", fill=False,
                         zorder=1.6, alpha=0.75)
        )
        ax.add_patch(
            mp.Rectangle(
                (pos[i, 0] - r, pos[i, 1] + r), 2 * r * health[i] / max(hmax[i], 1e-6),
                0.3, facecolor="green", alpha=0.75, zorder=1.5,
            )
        )
        if smax[i] > 0:
            ax.add_patch(
                mp.Rectangle((pos[i, 0] - r, pos[i, 1] + r + 0.35), 2 * r, 0.3,
                             linewidth=1, edgecolor="black", fill=False,
                             zorder=1.6, alpha=0.75)
            )
            ax.add_patch(
                mp.Rectangle(
                    (pos[i, 0] - r, pos[i, 1] + r + 0.35),
                    2 * r * shield[i] / smax[i],
                    0.3, facecolor="blue", alpha=0.75, zorder=1.5,
                )
            )
        # attack/heal line toward the target, scaled by the cooldown ratio
        # (reference :1613-1626)
        if target is not None and target[b][i] >= 0:
            j = int(target[b][i])
            cd = float(cd_ratio[b][i]) if cd_ratio is not None else 1.0
            dx = (pos[j, 0] - pos[i, 0]) * cd
            dy = (pos[j, 1] - pos[i, 1]) * cd
            ax.add_line(
                ml.Line2D([pos[i, 0], pos[i, 0] + dx],
                          [pos[i, 1], pos[i, 1] + dy],
                          color="red", linewidth=3, zorder=1.7)
            )
        ax.annotate(
            U.UNIT_NAMES[t][:3], pos[i], ha="center", va="center", fontsize=7,
            zorder=1.8,
        )

    canvas.draw()
    buf = np.asarray(canvas.buffer_rgba())[:, :, :3]
    return buf.copy()


def frames_for_env(recorded: List[Dict[str, np.ndarray]], b: int,
                   map_size: float, geometry=None) -> List[np.ndarray]:
    return [render_frame(rs, b, map_size, geometry=geometry) for rs in recorded]


def save_video(path: str, frames: List[np.ndarray], fps: int = 2) -> str:
    """mp4 via imageio/ffmpeg when available, else an animated GIF
    (this image ships imageio without the FFMPEG plugin). Returns the path
    actually written."""
    import imageio

    try:
        with imageio.get_writer(path, format="FFMPEG", mode="I", fps=fps,
                                codec="h264", quality=10) as w:
            for f in frames:
                w.append_data(f)
        return path
    except ImportError:
        gif = path.rsplit(".", 1)[0] + ".gif"
        imageio.mimsave(gif, frames, format="GIF", duration=1.0 / fps)
        return gif


def save_replay(path: str, recorded: List[Dict[str, np.ndarray]]) -> None:
    """The stand-in's replay format: the full recorded render-state trajectory
    as one npz (reference ``save_replay`` stores an SC2 replay file)."""
    flat = {}
    for k in recorded[0]:
        flat[k] = np.stack([rs[k] for rs in recorded])
    np.savez_compressed(path, **flat)
