"""The interactive viewer, as ``app.run_interactive`` runs it with
``--render``: each frame ``ParticleSystem.update()``, then
``PointRenderer.frame`` of the new state, then its uint8 image put on the
host double buffer (a side-stream copy into pinned memory) while the
previous frame's copy is waited for. A frame counts when its image has
reached host memory.

Traffic knobs: ``width``, ``height``, ``point_size``, ``color_mode`` (a
``ColorMode`` name), ``camera`` (``Camera`` keywords), ``warm_iters``,
``trace_lead``, ``trace_iters``."""

from portbench.trace import span


class Driver:
    def __init__(self, system, ctx):
        from nbody_tpu_torch import ColorMode, RenderConfig
        from nbody_tpu_torch.render.camera import Camera
        from nbody_tpu_torch.render.renderer import PointRenderer
        from nbody_tpu_torch.render.stream import HostDoubleBuffer

        t = ctx.traffic
        self.system = system
        self.renderer = PointRenderer(
            RenderConfig(window_width=int(t["width"]),
                         window_height=int(t["height"]),
                         point_size=float(t["point_size"]),
                         color_mode=ColorMode[t["color_mode"]]),
            Camera(**t["camera"]))
        self.copies = HostDoubleBuffer()
        self.warm_iters = int(t["warm_iters"])
        self.pending = None
        self.image = None   # the newest image on the host
        self.steps = 0

    def warm(self) -> None:
        for _ in range(self.warm_iters):
            self.step()
        self.finish()

    def step(self) -> int:
        with span("update"):
            self.system.update()
        self.steps += 1
        st = self.system.state
        with span("frame"):
            image = self.renderer.frame(st.pos, st.vel)
        with span("copy_put"):
            copy = self.copies.put(image)
        arrived = self._wait()
        self.pending = copy
        return arrived

    def _wait(self) -> int:
        if self.pending is None:
            return 0
        with span("copy_wait"):
            self.image = self.pending.wait()[0]
        self.pending = None
        return 1

    def finish(self) -> int:
        arrived = self._wait()
        with span("synchronize"):
            self.system.synchronize()
        return arrived

    def probe(self, steps: int) -> None:
        """``steps`` more ``update()`` calls, after the window (checked)."""
        for _ in range(steps):
            self.system.update()
        self.steps += steps
        self.system.synchronize()

    def final(self) -> dict:
        st = self.system.state
        return dict(pos=st.pos, vel=st.vel, acc=st.acc, mass=st.mass,
                    time=float(st.time), steps=self.steps,
                    image=self.image.clone())

    @staticmethod
    def end_to_end(units: int, window_s: float) -> dict:
        return {"frames_per_s": units / window_s}
