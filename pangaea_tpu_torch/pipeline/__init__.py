"""Pipeline layer: resumable steps 1-4 (reference: src/pangaea.py)."""

from pangaea_tpu_torch.pipeline.run import Pipeline, check_step_finished

__all__ = ["Pipeline", "check_step_finished"]
