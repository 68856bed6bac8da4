from lbm_tpu_torch.io.scene import Scene, load_obstacles, load_params, load_scene
from lbm_tpu_torch.io.writers import write_av_vels, write_final_state

__all__ = [
    "Scene",
    "load_params",
    "load_obstacles",
    "load_scene",
    "write_av_vels",
    "write_final_state",
]
