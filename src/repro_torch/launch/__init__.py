# Runtime layer: the step factory (steps.py) and the fault-tolerant train
# loop with the peel under worker loss (train.py). The mesh, the dry-run and
# the serving loop come with ROADMAP.md section 1, items 6d-6e.
from repro_torch.launch.steps import StepBundle, build_step, make_optimizer, train_state
from repro_torch.launch.train import (
    LoopConfig, LoopResult, peel_with_restarts, restore_elastic, run_training,
)

__all__ = ["LoopConfig", "LoopResult", "StepBundle", "build_step", "make_optimizer",
           "peel_with_restarts", "restore_elastic", "run_training", "train_state"]
