"""Headless simulation: ``ParticleSystem.run_steps(chunk)`` in a closed
loop, no host read between chunks, one synchronize at the window's end.

Traffic knobs: ``chunk_steps``, ``warm_iters`` (chunks before the window:
the capture and the first replays), ``trace_lead``, ``trace_iters``."""

from portbench.trace import span


class Driver:
    def __init__(self, system, ctx):
        self.system = system
        self.chunk = int(ctx.traffic["chunk_steps"])
        self.warm_iters = int(ctx.traffic["warm_iters"])
        self.steps = 0  # every step asked of the program, warm-up included

    def warm(self) -> None:
        for _ in range(self.warm_iters):
            self.step()
        self.finish()

    def step(self) -> int:
        with span("run_steps"):
            self.system.run_steps(self.chunk)
        self.steps += self.chunk
        return self.chunk

    def finish(self) -> int:
        with span("synchronize"):
            self.system.synchronize()
        return 0

    def probe(self, steps: int) -> None:
        """``steps`` more steps in one call, after the window (checked)."""
        self.system.run_steps(steps)
        self.steps += steps
        self.system.synchronize()

    def final(self) -> dict:
        st = self.system.state
        return dict(pos=st.pos, vel=st.vel, acc=st.acc, mass=st.mass,
                    time=float(st.time), steps=self.steps)

    @staticmethod
    def end_to_end(units: int, window_s: float) -> dict:
        return {"steps_per_s": units / window_s}
