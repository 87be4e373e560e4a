"""Renderers: cameras, the sweep and march G-buffers, AO, DVR and SSAO."""

from isosurfacesuperresolution_tpu_torch.render.camera import (
    CameraParams, look_at, perspective, project, random_sphere_camera)
from isosurfacesuperresolution_tpu_torch.render.raycast import (
    render_gbuffer, march_rays, gradient_normal, compute_ao, shade_hits,
    gbuffer_to_low_input, gbuffer_to_high_target, gbuffer_flow)
from isosurfacesuperresolution_tpu_torch.render.sweep import (
    render_gbuffer_sweep)
from isosurfacesuperresolution_tpu_torch.render.api import (
    render_frame_gbuffer)
from isosurfacesuperresolution_tpu_torch.render.ao_sweep import (
    bake_occlusion_sh, attach_baked_ao, ao_from_sh)
from isosurfacesuperresolution_tpu_torch.render.shading import (
    screen_space_shading, safe_normalize)
