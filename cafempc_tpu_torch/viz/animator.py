"""LCM animator: consume planned-trajectory viz messages and render them
(port of `cafempc_tpu/viz/animator.py`).

The in-repo consumer of the `visualize_wb_traj` channel, the headless
counterpart of the reference's PyBullet animator
(scripts/Visualization/animator.py + visualize_motion.py:47, which
subscribes to the same wbTraj_lcmt stream).  Each received trajectory is
rendered to a stick-figure GIF with matplotlib's Pillow writer, or to a
frame-strip PNG where that writer is not available.  The JAX module
writes the strip whenever anything in the animation fails; here only the
missing writer leads to the strip, and any other error propagates.

    from cafempc_tpu_torch.comms.udpm import LCMEndpoint, UDPMulticast
    from cafempc_tpu_torch.viz.animator import WBTrajAnimator
    anim = WBTrajAnimator(model, out_dir="viz_out")
    anim.serve(LCMEndpoint(UDPMulticast()), max_msgs=1)

or one-shot on a decoded message: `anim.render(msg)`.  `model` is the
whole-body model (`wbm.load_model`).
"""
import os
import time

import numpy as np

from cafempc_tpu_torch.comms import lcm_wire as w
from cafempc_tpu_torch.viz.plots import _mpl, stick_segments


class WBTrajAnimator:
    def __init__(self, model, out_dir="viz_out", fps=25, plane=(0, 2)):
        self.out_dir = out_dir
        self.model = model
        self.fps = fps
        self.plane = plane
        self.n_rendered = 0
        os.makedirs(out_dir, exist_ok=True)

    # ---------------- frame geometry --------------------------------
    def _frame_segments(self, X):
        """Stick-figure segments [n, 9, 2, 3] of the states X [n, >= 18]
        (pos, eul, qJ first)."""
        return stick_segments(self.model, X)

    def render(self, msg, name=None):
        """Render one wbTraj_lcmt to <out_dir>/<name>.gif, or to a
        frame-strip PNG where matplotlib's Pillow writer is not available.
        Returns the written path."""
        plt = _mpl()
        import matplotlib.animation as manim
        X = np.concatenate([
            np.asarray(msg.pos, dtype=float),
            np.asarray(msg.eul, dtype=float),
            np.asarray(msg.qJ, dtype=float)], axis=1)
        segs = self._frame_segments(X)
        a, b = self.plane
        name = name or f"wb_traj_{self.n_rendered:03d}"
        self.n_rendered += 1

        fig, ax = plt.subplots(figsize=(7, 4))
        ax.set_aspect("equal")
        ax.axhline(0.0, color="gray", lw=0.5)
        lo = np.asarray(msg.pos)[:, a].min() - 0.4
        hi = np.asarray(msg.pos)[:, a].max() + 0.4
        ax.set_xlim(lo, hi)
        ax.set_ylim(-0.05, 0.55)
        lines = [ax.plot([], [], "k-" if i == 0 else "b-",
                         lw=2 if i == 0 else 1)[0] for i in range(9)]

        def draw(k):
            for ln, (p0, p1) in zip(lines, segs[k]):
                ln.set_data([p0[a], p1[a]], [p0[b], p1[b]])
            return lines

        if manim.writers.is_available("pillow"):
            ani = manim.FuncAnimation(fig, draw, frames=X.shape[0],
                                      blit=True)
            path = os.path.join(self.out_dir, f"{name}.gif")
            ani.save(path, writer=manim.PillowWriter(fps=self.fps))
        else:
            path = os.path.join(self.out_dir, f"{name}.png")
            for frame in segs[::max(1, X.shape[0] // 12)]:
                for (p0, p1) in frame:
                    ax.plot([p0[a], p1[a]], [p0[b], p1[b]], "b-",
                            lw=1, alpha=0.5)
            fig.savefig(path, dpi=120)
        plt.close(fig)
        return path

    # ---------------- LCM service -----------------------------------
    def serve(self, endpoint, channel="visualize_wb_traj", max_msgs=None,
              timeout=None):
        """Blocking subscribe-decode-render loop (animator.py analogue) on
        a `comms.udpm.LCMEndpoint`.  Returns the list of written file
        paths."""
        got = []
        endpoint.subscribe(channel, w.wbTraj_lcmt,
                           lambda _c, m: got.append(m))
        written = []
        t0 = time.time()
        while max_msgs is None or len(written) < max_msgs:
            endpoint.handle(timeout=0.25)
            while got:
                written.append(self.render(got.pop(0)))
            if timeout is not None and time.time() - t0 > timeout:
                break
        return written
