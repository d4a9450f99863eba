# Runtime layer: the step factory (steps.py), the LM serving loop (serve.py),
# and the fault-tolerant train loop with the peel under worker loss
# (train.py). The mesh and the dry-run come with ROADMAP.md section 1, item 6e.
from repro_torch.launch.serve import ServeStats, serve_batch, serve_metrics_endpoint
from repro_torch.launch.steps import StepBundle, build_step, make_optimizer, train_state
from repro_torch.launch.train import (
    LoopConfig, LoopResult, peel_with_restarts, restore_elastic, run_training,
)

__all__ = ["LoopConfig", "LoopResult", "ServeStats", "StepBundle", "build_step",
           "make_optimizer", "peel_with_restarts", "restore_elastic", "run_training",
           "serve_batch", "serve_metrics_endpoint", "train_state"]
