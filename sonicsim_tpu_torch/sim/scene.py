"""Scene: room + navigable space + RIR oracle + channel model, on a device.

Port of the JAX package's ``sim/scene.py``: a plain composition of a NavGrid
for geometry queries, an RIR oracle for acoustics and a ChannelModel for the
mic, with the sampling entry points of the generation pipeline.

``device`` is where the scene's work runs: its RIR banks (a synthetic scene
builds its oracle on it), and the mixture step and utterance cache of
generation, which read it from the scene. ``None`` is the card; where CUDA
is absent that raises (``bridge.resolve_device``), and ``"cpu"`` runs on the
CPU.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np
import torch

from ..bridge import resolve_device
from .channels import ChannelModel
from .geometry import (
    NavGrid,
    generate_xy_grid_points,
    sample_trajectory,
    select_static_points,
)
from .image_source import ShoeboxRoom
from .materials import Material
from .oracle import ACOUSTIC_CONFIG, RirOracle, SyntheticRirOracle, render_rir_bank

logger = logging.getLogger(__name__)


@dataclass
class Scene:
    room: str
    nav: NavGrid
    oracle: RirOracle
    channel: ChannelModel
    source_height: float = 1.5  # reference adds 1.5 m at SonicSim_rir.py:411
    sensor_height: float = 1.5  # aihabitat sensor_height (SonicSim_rir.py:175)
    acoustic_config: dict = field(default_factory=lambda: dict(ACOUSTIC_CONFIG))
    device: str | None = None

    @classmethod
    def synthetic(
        cls,
        room: str = "shoebox",
        dims: tuple[float, float, float] = (10.0, 3.0, 8.0),
        absorption: float | Material = 0.3,
        channel_type: str = "Binaural",
        channel_order: int = 1,
        mic_array: list | None = None,
        sample_rate: int = 16000,
        resolution: float = 0.25,
        max_order: int = 4,
        seed: int = 0,
        n_bands: int = 0,
        wall_materials: dict | list | None = None,
        materials: dict | None = None,
        device: str | None = None,
    ) -> "Scene":
        """Scene over a shoebox room, rendering on ``device``.

        ``n_bands=32`` matches the reference's frequency-dependent material
        model and routes bank rendering through the batched renderer
        (sim/bank_render.py); ``n_bands=0`` keeps the flat serial renderer.
        ``wall_materials`` assigns per-wall material labels (a dict like
        ``{"floor": "carpet", "ceiling": "concrete", "walls": "concrete"}``
        or a 6-list in image_source.WALLS order), resolved against
        ``materials`` (built-ins otherwise); it needs ``n_bands > 0``."""
        room_kwargs: dict = {}
        if isinstance(absorption, Material):
            # A Material carries all four curve families: keep them all
            # (broadband means; per-wall diversity via wall_materials).
            room_kwargs["absorption"] = absorption.mean_absorption()
            room_kwargs["scattering"] = absorption.mean_scattering()
            room_kwargs["transmission"] = float(
                np.mean(absorption.transmission)
            )
            room_kwargs["damping"] = float(np.mean(absorption.damping))
        else:
            room_kwargs["absorption"] = float(absorption)
        if wall_materials is not None:
            if n_bands <= 0:
                raise ValueError(
                    "wall_materials needs the multiband renderer; set "
                    "n_bands > 0 (the reference uses 32)"
                )
            from .materials import wall_curves_from_labels

            room_kwargs.update(
                wall_curves_from_labels(
                    wall_materials, materials,
                    n_bands=n_bands, sample_rate=sample_rate,
                )
            )
        nav = NavGrid.rectangle(dims[0], dims[2], resolution=resolution)
        oracle = SyntheticRirOracle(
            room=ShoeboxRoom(dims, **room_kwargs),
            sample_rate=sample_rate,
            max_order=max_order,
            seed=seed,
            n_bands=n_bands,
            device=device,
        )
        return cls(
            room=room,
            nav=nav,
            oracle=oracle,
            channel=ChannelModel(channel_type, channel_order, mic_array),
            device=device,
        )

    @classmethod
    def from_bank(
        cls,
        bank_path: str,
        room: str | None = None,
        channel_type: str = "Binaural",
        channel_order: int = 1,
        mic_array: list | None = None,
        resolution: float = 0.25,
        margin: float = 1.0,
        device: str | None = None,
    ) -> "Scene":
        """Scene over a precomputed RIR bank (.npz via BankRirOracle).
        Navigable space is the x/z bounding box of the bank's stored
        source/receiver positions (+``margin``); RIR lookups snap to the
        nearest stored pair."""
        from pathlib import Path

        from .oracle import BankRirOracle

        oracle = BankRirOracle(bank_path)
        pos = np.concatenate(
            [oracle._data["source_positions"],
             oracle._data["receiver_positions"]]
        )
        x0 = float(pos[:, 0].min()) - margin
        z0 = float(pos[:, 2].min()) - margin
        nx = max(int(round((float(pos[:, 0].max()) + margin - x0) / resolution)), 1)
        nz = max(int(round((float(pos[:, 2].max()) + margin - z0) / resolution)), 1)
        nav = NavGrid(
            np.ones((nx, nz), bool), (x0, z0), resolution,
            # sampled points get +sensor/source_height (1.5 m): place the
            # floor so elevated points land at the stored bank height.
            floor_height=float(pos[:, 1].mean()) - 1.5,
        )
        return cls(
            room=room or Path(bank_path).stem,
            nav=nav,
            oracle=oracle,
            channel=ChannelModel(channel_type, channel_order, mic_array),
            device=device,
        )

    # --- sampling (generation pipeline entry points) ----------------------
    def sample_trajectory(
        self, rng: np.random.Generator, distance_threshold: float = 5.0
    ) -> list[np.ndarray]:
        return sample_trajectory(self.nav, rng, distance_threshold)

    def select_static_points(
        self,
        anchors: list[np.ndarray],
        rng: np.random.Generator,
        distance_threshold: float = 6.0,
        num_points: int = 1,
    ) -> list[np.ndarray]:
        return select_static_points(
            self.nav, anchors, rng, distance_threshold, num_points
        )

    def grid_points(self, grid_distance: float) -> np.ndarray:
        return generate_xy_grid_points(self.nav, grid_distance)

    # --- rendering --------------------------------------------------------
    def _elevate(self, p: np.ndarray, h: float) -> np.ndarray:
        q = np.asarray(p, np.float64).copy()
        q[1] += h
        return q

    def render_ir(
        self,
        source_position: np.ndarray,
        receiver_position: np.ndarray,
        receiver_rotation: float = 90.0,
    ) -> np.ndarray:
        """(C, L) RIR with the reference's height conventions."""
        return self.oracle.render(
            self._elevate(source_position, self.source_height),
            self._elevate(receiver_position, self.sensor_height),
            self.channel,
            receiver_rotation,
        )

    def render_ir_all(
        self,
        source_positions: list[np.ndarray],
        receiver_position: np.ndarray,
        receiver_rotation: float = 90.0,
    ) -> list[np.ndarray]:
        """Per-source RIRs at one receiver."""
        return [
            self.render_ir(p, receiver_position, receiver_rotation)
            for p in source_positions
        ]

    def generate_data(
        self,
        source_positions: list[np.ndarray],
        receiver_position: np.ndarray,
        receiver_rotation: float = 90.0,
        dry_sounds: list | None = None,
        use_dry_sound: bool = False,
    ) -> dict:
        """One-call scene render (the reference's Scene.generate_data).

        Returns ``ir_list`` (per-source (C, L) RIRs), ``sample_rate``,
        ``envmap`` (always [None, None]: no visual sensor in this build),
        and, when ``use_dry_sound``, each dry sound convolved with its RIR
        on the scene's device (``audio_list``) plus the loaded dry sounds.
        ``dry_sounds`` entries may be arrays or wav paths."""
        from ..ops.fftconv import convolve_fixed_receiver
        from ..utils.wavio import read_wav

        ir_list = self.render_ir_all(
            source_positions, receiver_position, receiver_rotation
        )
        audio_list: list[np.ndarray] = []
        dry_list: list[np.ndarray] = []
        if use_dry_sound:
            if dry_sounds is None or len(dry_sounds) != len(source_positions):
                raise ValueError("use_dry_sound requires one dry sound per source")
            device = resolve_device(self.device)
            for dry, ir in zip(dry_sounds, ir_list):
                if isinstance(dry, (str, bytes)):
                    dry, _sr = read_wav(dry)
                dry = np.asarray(dry, np.float32)
                if dry.ndim > 1:
                    dry = dry[0]
                wet = convolve_fixed_receiver(
                    torch.from_numpy(dry).to(device),
                    torch.as_tensor(np.asarray(ir, np.float32), device=device),
                )
                audio_list.append(wet.cpu().numpy())
                dry_list.append(dry)
        return dict(
            ir_list=ir_list,
            sample_rate=getattr(self.oracle, "sample_rate", 16000),
            envmap=[None, None],
            audio_list=audio_list,
            dry_sound_list=dry_list,
        )

    def render_custom_arrayir(
        self,
        source_position: np.ndarray,
        receiver_position: np.ndarray,
        mic_array: list,
        receiver_rotation: float = 90.0,
    ) -> np.ndarray:
        """(n_mics, L) RIR for an ad-hoc mic array at one receiver pose."""
        chan = ChannelModel("CustomArrayIR", self.channel.channel_order, mic_array)
        return self.oracle.render(
            self._elevate(source_position, self.source_height),
            self._elevate(receiver_position, self.sensor_height),
            chan,
            receiver_rotation,
        )

    def render_bank(
        self,
        source_positions: list[np.ndarray],
        receiver_positions: list[np.ndarray],
        receiver_rotations: list[float] | None = None,
    ) -> np.ndarray:
        """(S, R, C, L) all-pairs bank, peak-normalized."""
        return render_rir_bank(
            self.oracle,
            [self._elevate(p, self.source_height) for p in source_positions],
            [self._elevate(p, self.sensor_height) for p in receiver_positions],
            self.channel,
            receiver_rotations,
        )

    def render_banks(
        self,
        source_lists: list[list[np.ndarray]],
        receiver_positions: list[np.ndarray],
        receiver_rotations: list[float] | None = None,
        out_device: bool = False,
        mesh=None,
    ) -> list:
        """Several banks (one per speaker trajectory), each peak-normalised
        on its own: in one batched render when the oracle is a multiband
        synthetic one, else bank by bank. With ``out_device=True`` the banks
        are tensors on the scene's device, else numpy. With ``mesh`` the
        batched render's items are sharded over it (the multi-device RIR
        fan-out), and the banks gathered on its first device; another
        oracle renders bank by bank, unsharded, as in the JAX package, and
        says so in a warning."""
        recvs = [self._elevate(p, self.sensor_height) for p in receiver_positions]
        if isinstance(self.oracle, SyntheticRirOracle) and self.oracle.n_bands > 0:
            from .bank_render import render_rir_banks

            return render_rir_banks(
                self.oracle,
                [
                    [self._elevate(p, self.source_height) for p in lst]
                    for lst in source_lists
                ],
                recvs,
                self.channel,
                receiver_rotations,
                out_device=out_device,
                mesh=mesh,
            )
        if mesh is not None:
            logger.warning("render_banks(mesh=...): %s renders bank by bank, unsharded",
                           type(self.oracle).__name__)
        banks = [
            render_rir_bank(
                self.oracle,
                [self._elevate(p, self.source_height) for p in lst],
                recvs,
                self.channel,
                receiver_rotations,
            )
            for lst in source_lists
        ]
        if not out_device:
            return banks
        device = resolve_device(self.device)
        return [torch.from_numpy(b).to(device) for b in banks]
