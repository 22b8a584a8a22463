"""Acoustic simulation: rooms, channels, materials, RIR oracles and the
batched RIR-bank renderer (port of ``sonicsim_tpu.sim``)."""

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
    RirOracle,
    SyntheticRirOracle,
    render_rir_bank,
    save_rir_bank,
)

__all__ = [
    "ACOUSTIC_CONFIG",
    "BankRirOracle",
    "CHANNEL_TYPES",
    "CIRCULAR_4CH_ARRAY",
    "ChannelModel",
    "DEFAULT_MATERIALS",
    "LINEAR_4CH_ARRAY",
    "Material",
    "Receiver",
    "RirOracle",
    "ShoeboxRoom",
    "Source",
    "SyntheticRirOracle",
    "WALLS",
    "WallPhysics",
    "band_centers",
    "band_masks",
    "channel_count",
    "image_sources",
    "image_sources_walls",
    "load_material_config",
    "material_for_label",
    "real_sh_matrix",
    "render_bank_batched",
    "render_rir_bank",
    "render_rir_banks",
    "render_shoebox_rir",
    "render_shoebox_rir_multiband",
    "room_mean_absorption",
    "save_rir_bank",
    "tail_noise",
    "wall_curves_from_labels",
]
