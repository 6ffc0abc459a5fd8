"""A new training job from the scene's touch seed points.  The traffic's
``start``: ``setup_until``, the step set-up trains to (exclusive), the
preset's warm-up and its first refine, which the traffic needs.

The program makes the start from the seed points (``Trainer.__init__``);
the reference works it out again from the same points
(``reference.densify.start_state``) for the check steps.
"""
from perfbench import job as jobs
from perfbench.reference import densify as ref_densify


class NewJob(jobs.Job):
    def start(self, say) -> int:
        return self.traffic["start"]["setup_until"]

    def check_start(self) -> dict:
        if self.start_host is None:
            t = self.cfg["train"]
            pts = self.scene.seed_points
            # the capacity a new job starts at, doubled as it grows
            cap = t["model"]["max_gaussians"]
            if t["grow_capacity"]:
                cap = min(cap, t["init_capacity"] or max(
                    1 << max(2 * len(pts) - 1, 1).bit_length(), 4096))
            self.start_host = ref_densify.start_state(
                pts, self.scene.seed_colors, cap, t)
        return self.start_host


def setup(cfg, traffic, seed, device, log=None):
    run = NewJob(cfg, traffic, seed, device)
    run.setup(log)
    return run
