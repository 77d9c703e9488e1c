"""Plotting helpers: a diverging orange-blue colormap, a field plotter and
movie assembly (counterpart of ``sopht_mpi_tpu/utils/plotting.py``).

Counterpart of the reference's ``lab_cmap`` (sopht_mpi/utils/lab_cmap.py)
and ``MPIPlotter2D`` (mpi_utils_2d.py:715-841). Fields (tensors on any
device, or arrays) are copied to the host for rendering; like the
reference, for debug-scale snapshots. matplotlib is imported at first use
(a :class:`Plotter2D`, or the first read of ``lab_cmap``, which is None
without matplotlib), not when this module is imported.
"""

from __future__ import annotations

import functools
import os

import numpy as np

from sopht_mpi_tpu_torch.utils.native_io import to_host


@functools.cache
def _lab_cmap():
    try:
        from matplotlib.colors import LinearSegmentedColormap
    except ImportError:
        return None
    # diverging blue -> white -> orange (the reference's lab palette spirit)
    return LinearSegmentedColormap.from_list(
        "lab_cmap",
        [
            (0.0, (0.0, 0.27, 0.62)),
            (0.5, (1.0, 1.0, 1.0)),
            (1.0, (0.93, 0.41, 0.0)),
        ],
    )


def __getattr__(name):
    # ``lab_cmap`` is built (and matplotlib imported) at its first read
    if name == "lab_cmap":
        return _lab_cmap()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class Plotter2D:
    """Minimal matplotlib wrapper mirroring MPIPlotter2D's surface
    (contourf/scatter/plot/savefig/clearfig). Debug-scale only (the
    reference warns the same, mpi_utils_2d.py:721-723)."""

    def __init__(self, fig_size=(10, 10), title=""):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        self._plt = plt
        self.fig = plt.figure(frameon=True, dpi=150, figsize=fig_size)
        self.ax = self.fig.add_subplot(111)
        self.ax.set_title(title)
        self.ax.set_aspect(aspect="equal")

    def contourf(self, x, y, field, *args, **kwargs):
        kwargs.setdefault("cmap", _lab_cmap())
        cobj = self.ax.contourf(
            to_host(x), to_host(y), to_host(field), *args, **kwargs
        )
        self._cbar = self.fig.colorbar(mappable=cobj, ax=self.ax)

    def scatter(self, x, y, *args, **kwargs):
        self.ax.scatter(to_host(x), to_host(y), *args, **kwargs)

    def plot(self, x, y, *args, **kwargs):
        self.ax.plot(to_host(x), to_host(y), *args, **kwargs)

    def savefig(self, file_name, *args, **kwargs):
        self.fig.savefig(
            file_name, bbox_inches="tight", pad_inches=0, *args, **kwargs
        )

    def clearfig(self):
        # remove the colorbar BEFORE clearing the axes (removing it after
        # cla() trips matplotlib's gridspec bookkeeping)
        if getattr(self, "_cbar", None) is not None:
            try:
                self._cbar.remove()
            except (AttributeError, KeyError):  # already detached
                pass
            self._cbar = None
        self.ax.cla()


def compile_video(frame_glob: str, output: str = "flow.mp4", fps: int = 10):
    """Assemble saved snapshot frames into a movie - the role of the
    reference examples' post-loop ffmpeg call
    (flow_past_cylinder.py:172-179). Uses ffmpeg when present; otherwise
    falls back to an animated GIF via Pillow (rewriting ``output``'s
    extension), so headless images without ffmpeg still produce a movie.

    :param frame_glob: glob matching the frames in order, e.g.
        ``"snap_*.png"`` (lexicographic sort = temporal order for
        zero-padded indices).
    :returns: the path actually written, or None when no frames matched.
    """
    import glob
    import shutil
    import subprocess

    frames = sorted(glob.glob(frame_glob))
    if not frames:
        return None
    if shutil.which("ffmpeg"):
        # concat demuxer: robust to arbitrary frame names
        list_file = output + ".frames.txt"

        def _entry(path):
            # concat-demuxer quoting: single quotes in the path must be
            # closed, escaped, reopened ('\'' idiom), or such paths break
            # the list parse
            quoted = os.path.abspath(path).replace("'", "'\\''")
            return f"file '{quoted}'\n"

        try:
            with open(list_file, "w") as f:
                for fr in frames:
                    f.write(_entry(fr))
                    f.write(f"duration {1.0 / fps}\n")
                # the demuxer ignores the duration after the LAST entry
                # unless the file is listed once more (ffmpeg slideshow
                # quirk) - without this the final frame flashes by
                f.write(_entry(frames[-1]))
            proc = subprocess.run(
                ["ffmpeg", "-y", "-f", "concat", "-safe", "0",
                 "-i", list_file,
                 "-vf", "pad=ceil(iw/2)*2:ceil(ih/2)*2",
                 "-pix_fmt", "yuv420p", output],
                capture_output=True, text=True,
            )
        finally:
            if os.path.exists(list_file):
                os.remove(list_file)
        if proc.returncode == 0:
            return output
        # a present-but-failing ffmpeg (codec build, unwritable output)
        # must not crash a finished run: log and degrade to the GIF path
        from sopht_mpi_tpu_torch.utils.logging_utils import logger

        logger.warning(
            f"ffmpeg failed (rc={proc.returncode}): "
            f"{proc.stderr.strip().splitlines()[-1] if proc.stderr else ''}"
            " - falling back to an animated GIF"
        )
    # Pillow GIF fallback - optional too: a host with neither ffmpeg nor
    # Pillow must not raise at the end of an otherwise-finished run
    try:
        from PIL import Image
    except ImportError:
        from sopht_mpi_tpu_torch.utils.logging_utils import logger

        logger.warning(
            "movie assembly skipped: neither ffmpeg nor Pillow available "
            f"(frames remain on disk: {frame_glob})"
        )
        return None

    gif = os.path.splitext(output)[0] + ".gif"
    imgs = []
    for fr in frames:
        with Image.open(fr) as im:
            imgs.append(im.convert("P"))  # convert() copies; file closes
    imgs[0].save(
        gif, save_all=True, append_images=imgs[1:],
        duration=int(1000 / fps), loop=0,
    )
    return gif
