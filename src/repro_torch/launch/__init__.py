# Runtime layer: the step factory (steps.py), the LM serving loop (serve.py),
# the fault-tolerant train loop with the peel under worker loss (train.py),
# mesh layouts and the production meshes (mesh.py), and the dry run of every
# cell on the meta device (dryrun.py, with hlo_analysis.py's parser of XLA's
# collectives kept beside it).
from repro_torch.launch.mesh import (
    MeshLayout, dp_axes, dry_mesh, make_local_mesh, make_production_mesh, n_devices,
)
from repro_torch.launch.serve import ServeStats, serve_batch, serve_metrics_endpoint
from repro_torch.launch.steps import (
    StepBundle, all_cells, build_step, make_optimizer, train_state,
)
from repro_torch.launch.train import (
    LoopConfig, LoopResult, peel_with_restarts, restore_elastic, run_training,
)

__all__ = ["LoopConfig", "LoopResult", "MeshLayout", "ServeStats", "StepBundle", "all_cells",
           "build_step", "dp_axes", "dry_mesh", "make_local_mesh", "make_production_mesh",
           "n_devices",
           "make_optimizer", "peel_with_restarts", "restore_elastic", "run_training",
           "serve_batch", "serve_metrics_endpoint", "train_state"]
