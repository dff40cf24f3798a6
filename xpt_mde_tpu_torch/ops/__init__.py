from xpt_mde_tpu_torch.ops.camera import (
    cam2pixel,
    pixel2cam,
    pixel_grid,
    reproject_pixel_coords,
    scale_intrinsics,
    transform_to_source,
)
from xpt_mde_tpu_torch.ops.synthesize import (synthesize_multi_scale,
                                              synthesize_single_scale)
from xpt_mde_tpu_torch.ops.warp import bilinear_sample, bilinear_sample_plain
