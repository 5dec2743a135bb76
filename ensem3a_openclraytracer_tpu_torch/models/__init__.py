"""Renderers: the path tracer, the path-replay gradient engine and
inverse-rendering optimization."""

from ensem3a_openclraytracer_tpu_torch.models.optimize import (
    Adam,
    AdamState,
    TrainableParams,
    image_loss,
    iteration_generator,
    load_optimizer_checkpoint,
    make_train_step,
    render_for_grad,
    run_optimization,
    save_optimizer_checkpoint,
)
from ensem3a_openclraytracer_tpu_torch.models.pathtracer import (
    render_image,
    render_radiance,
    render_radiance_jit,
    render_scene,
    trace,
)
from ensem3a_openclraytracer_tpu_torch.models.replay import (
    PathRecords,
    radiance_for_rays_replay,
    record_paths,
    record_paths_fused,
    render_radiance_replay,
    replay_radiance,
)

__all__ = [
    "Adam",
    "AdamState",
    "PathRecords",
    "TrainableParams",
    "image_loss",
    "iteration_generator",
    "load_optimizer_checkpoint",
    "make_train_step",
    "radiance_for_rays_replay",
    "record_paths",
    "record_paths_fused",
    "render_for_grad",
    "render_image",
    "render_radiance",
    "render_radiance_jit",
    "render_radiance_replay",
    "render_scene",
    "replay_radiance",
    "run_optimization",
    "save_optimizer_checkpoint",
    "trace",
]
