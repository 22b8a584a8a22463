"""Acoustic simulation: rooms, channels, materials, RIR oracles, the
batched RIR-bank renderer, navigable space and scenes (port of
``sonicsim_tpu.sim``), the live habitat oracle and the visual path
(``sim.visual``)."""

from .bank_render import render_bank_batched, render_rir_banks
from .channels import (
    CHANNEL_TYPES,
    CIRCULAR_4CH_ARRAY,
    LINEAR_4CH_ARRAY,
    ChannelModel,
    channel_count,
    real_sh_matrix,
)
from .entities import Receiver, Source
from .geometry import (
    NavGrid,
    densify_path,
    generate_xy_grid_points,
    interpolate_receiver_poses,
    random_select_start_end_points,
    sample_trajectory,
    select_static_points,
)
from .grid_cache import grid_cache_path, load_room_grid, save_xy_grid_points
from .image_source import (
    WALLS,
    ShoeboxRoom,
    WallPhysics,
    band_centers,
    band_masks,
    image_sources,
    image_sources_walls,
    render_shoebox_rir,
    render_shoebox_rir_multiband,
    tail_noise,
)
from .maps import points_to_pixels, save_trace_image, topdown_map
from .materials import (
    DEFAULT_MATERIALS,
    Material,
    load_material_config,
    material_for_label,
    room_mean_absorption,
    wall_curves_from_labels,
)
from .oracle import (
    ACOUSTIC_CONFIG,
    BankRirOracle,
    HabitatRirOracle,
    RirOracle,
    SyntheticRirOracle,
    render_rir_bank,
    save_rir_bank,
)
from .scene import Scene
from .visual import habitat_render_fn, interpolate_rgb_images, render_envmap, topdown_render_fn

__all__ = [
    "ACOUSTIC_CONFIG",
    "band_centers",
    "band_masks",
    "BankRirOracle",
    "channel_count",
    "CHANNEL_TYPES",
    "ChannelModel",
    "CIRCULAR_4CH_ARRAY",
    "DEFAULT_MATERIALS",
    "densify_path",
    "generate_xy_grid_points",
    "grid_cache_path",
    "habitat_render_fn",
    "HabitatRirOracle",
    "image_sources",
    "image_sources_walls",
    "interpolate_receiver_poses",
    "interpolate_rgb_images",
    "LINEAR_4CH_ARRAY",
    "load_material_config",
    "load_room_grid",
    "Material",
    "material_for_label",
    "NavGrid",
    "points_to_pixels",
    "random_select_start_end_points",
    "real_sh_matrix",
    "Receiver",
    "render_bank_batched",
    "render_envmap",
    "render_rir_bank",
    "render_rir_banks",
    "render_shoebox_rir",
    "render_shoebox_rir_multiband",
    "RirOracle",
    "room_mean_absorption",
    "sample_trajectory",
    "save_rir_bank",
    "save_trace_image",
    "save_xy_grid_points",
    "Scene",
    "select_static_points",
    "ShoeboxRoom",
    "Source",
    "SyntheticRirOracle",
    "tail_noise",
    "topdown_map",
    "topdown_render_fn",
    "wall_curves_from_labels",
    "WallPhysics",
    "WALLS",
]
