"""A training job resumed in its polish phase.  The traffic's ``start``:

- ``step``: the step the job resumes at;
- ``adam_nu``: Adam's second moments there (``scene.state``);
- ``k_tile``: the per-tile cap the job's truncation guard had reached,
  which its checkpoint records beside the state;
- ``warmup_steps`` (optional): steps set-up trains past its first period,
  so that the window starts at the step's steady rate: on an H100 a
  process's first 500 to 2000 steps ran 5% slower, by a cause not found
  (PERF.md), and a window that began among them read a lower rate.

The state is ``scene.state.surface_state`` from the seed, entered through
the program's resume path: a checkpoint written by ``CheckpointManager
.save`` and read by ``restore_trainer``, as ``cli.py train --load-run``
resumes.
"""
import shutil
import tempfile

from perfbench import job as jobs
from perfbench.scene import state as start_states


class ResumedJob(jobs.Job):
    def start(self, say) -> int:
        from touchgs_torch.train.checkpoint import (CheckpointManager,
                                                    restore_trainer)

        start = self.traffic["start"]
        st = start_states.surface_state(self.cfg, self.traffic, self.seed,
                                        self.device)
        self.start_host = jobs.host(st)
        extra = {"k_tile": start["k_tile"]} if start.get("k_tile") else None
        run_dir = tempfile.mkdtemp(prefix="perfbench_run_")
        try:
            CheckpointManager(run_dir).save(st["step"],
                                            jobs.program_state(st),
                                            extra=extra)
            restore_trainer(self.trainer, CheckpointManager(run_dir))
        finally:
            shutil.rmtree(run_dir, ignore_errors=True)
        self.k_tile = self.trainer._k_tile or self.k_tile
        return (start["step"] + self.traffic["period"]
                + start.get("warmup_steps", 0))


def setup(cfg, traffic, seed, device, log=None):
    run = ResumedJob(cfg, traffic, seed, device)
    run.setup(log)
    return run
