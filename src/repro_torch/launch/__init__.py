# Runtime layer: the step factory (steps.py) for the ported cells. The mesh,
# the dry-run, the train loop and the serving loop come with ROADMAP.md
# section 1, item 13.
from repro_torch.launch.steps import StepBundle, build_step

__all__ = ["StepBundle", "build_step"]
