"""RIR oracles: the isolation boundary around acoustic simulation.

Port of ``sonicsim_tpu/sim/oracle.py``. The framework consumes RIRs through
the ``RirOracle`` protocol:

1. ``SyntheticRirOracle`` — the built-in shoebox image-source engine, here
   in torch on ``device`` (the card unless it names another);
2. ``BankRirOracle`` — precomputed per-scene banks (.npz, read by
   ``bridge.load_rir_bank``);
3. ``HabitatRirOracle`` — the live habitat-sim adapter (host code; its
   ``habitat`` module is injectable, and imported only when not given).

``render_rir_bank`` renders all (source, receiver) pairs of a bank, through
the batched renderer (``bank_render``) whenever the oracle is multiband.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Protocol, runtime_checkable

import numpy as np

from ..bridge import load_rir_bank
from .channels import ChannelModel
from .image_source import (
    ShoeboxRoom,
    render_shoebox_rir,
    render_shoebox_rir_multiband,
)

# Acoustic defaults matching the reference's fixed config
# (SonicSim_rir.py:176-187) — metadata for bank generation & parity checks.
ACOUSTIC_CONFIG = {
    "sampleRate": 16000,
    "direct": True,
    "indirect": True,
    "diffraction": True,
    "transmission": True,
    "directSHOrder": 5,
    "indirectSHOrder": 3,
    "unitScale": 1,
    "frequencyBands": 32,
    "indirectRayCount": 50000,
}


@runtime_checkable
class RirOracle(Protocol):
    sample_rate: int

    def render(
        self,
        source_position: np.ndarray,
        receiver_position: np.ndarray,
        channel: ChannelModel,
        receiver_rotation: float = 90.0,
    ) -> np.ndarray:  # (C, L)
        ...


@dataclass
class SyntheticRirOracle:
    """Image-source + stochastic-tail oracle over a shoebox approximation.

    ``n_bands > 0`` enables the frequency-dependent renderer (32 bands
    matches the reference acoustic config, SonicSim_rir.py:185). The fields
    before ``device`` are the reference oracle's; ``device`` is where it
    renders (the card unless given, ``"cpu"`` for the CPU)."""

    room: ShoeboxRoom
    sample_rate: int = 16000
    max_order: int = 4
    ir_seconds: float | None = None
    seed: int = 0
    n_bands: int = 0
    device: str | None = None

    def render(
        self,
        source_position: np.ndarray,
        receiver_position: np.ndarray,
        channel: ChannelModel,
        receiver_rotation: float = 90.0,
    ) -> np.ndarray:
        # Deterministic per-pair tail seed: Python's hash() of the rounded
        # position tuple (float tuples are not salted), in uint32.
        pair = np.concatenate([np.ravel(source_position), np.ravel(receiver_position)])
        seed = int(
            np.uint32(self.seed)
            + np.uint32(abs(hash(tuple(np.round(pair, 4).tolist()))) % (2**31))
        )
        kwargs = dict(
            sample_rate=self.sample_rate,
            receiver_rotation=receiver_rotation,
            max_order=self.max_order,
            ir_seconds=self.ir_seconds,
            seed=seed,
            device=self.device,
        )
        if self.n_bands > 0:
            return render_shoebox_rir_multiband(
                self.room, source_position, receiver_position, channel,
                n_bands=self.n_bands, **kwargs,
            )
        return render_shoebox_rir(
            self.room, source_position, receiver_position, channel, **kwargs
        )


@dataclass
class BankRirOracle:
    """Precomputed RIR bank: .npz with arrays ``rirs (S, R, C, L)``,
    ``source_positions (S, 3)``, ``receiver_positions (R, 3)``, scalar
    ``sample_rate``. Lookup = nearest stored position pair."""

    path: str | Path
    sample_rate: int = 16000
    _data: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        self._data = load_rir_bank(self.path, self.sample_rate)
        self.sample_rate = self._data["sample_rate"]

    def render(
        self,
        source_position: np.ndarray,
        receiver_position: np.ndarray,
        channel: ChannelModel,
        receiver_rotation: float = 90.0,
    ) -> np.ndarray:
        src = np.asarray(source_position, np.float64)
        rcv = np.asarray(receiver_position, np.float64)
        s = int(
            np.argmin(np.linalg.norm(self._data["source_positions"] - src, axis=1))
        )
        r = int(
            np.argmin(np.linalg.norm(self._data["receiver_positions"] - rcv, axis=1))
        )
        rir = self._data["rirs"][s, r]
        if rir.shape[0] != channel.count:
            raise ValueError(
                f"bank has {rir.shape[0]} channels, requested {channel.count}"
            )
        return np.asarray(rir, np.float32)


class HabitatRirOracle:
    """Live habitat-sim adapter: one persistent Simulator + audio sensor,
    re-posed per render (SonicSim_rir.py:214-436 role: create_scene →
    add_audio_sensor → update_receiver/update_source → render_ir).

    Unlike the reference — which owns trajectory sampling, audio, and
    rendering in one Scene god-object — this is only the acoustic backend
    behind the ``RirOracle`` protocol, so banks rendered live drop into the
    same pipeline as synthetic/precomputed ones. ``habitat`` is injectable
    for tests (a mock module); by default the real habitat_sim is imported.
    Host code, as in the JAX package: ``render`` returns a (C, L) float32
    numpy IR, as the port's other oracles do.
    """

    def __init__(
        self,
        scene_glb: str | Path,
        navmesh: str | Path | None = None,
        material_json: str | Path | None = None,
        channel: ChannelModel | None = None,
        sample_rate: int = 16000,
        sensor_height: float = 1.5,
        acoustic_config: dict | None = None,
        seed: int = 0,
        habitat=None,
    ):
        if habitat is None:
            try:
                import habitat_sim as habitat  # noqa: F811
            except ImportError as e:
                raise ImportError(
                    "habitat_sim is not installed. Render RIR banks offline "
                    "with the reference pipeline and load them via "
                    "BankRirOracle, or use SyntheticRirOracle."
                ) from e
        self._hs = habitat
        self.sample_rate = int(sample_rate)
        self.sensor_height = float(sensor_height)
        cfg = dict(ACOUSTIC_CONFIG, sampleRate=self.sample_rate)
        cfg.update(acoustic_config or {})

        # Simulator over the scene mesh (create_scene, rir.py:214-258).
        backend_cfg = habitat.SimulatorConfiguration()
        backend_cfg.scene_id = str(scene_glb)
        backend_cfg.load_semantic_mesh = True
        backend_cfg.enable_physics = False
        agent_cfg = habitat.agent.AgentConfiguration()
        self.sim = habitat.Simulator(
            habitat.Configuration(backend_cfg, [agent_cfg])
        )
        if navmesh is not None:
            self.sim.pathfinder.load_nav_mesh(str(navmesh))
        self.sim.seed(int(seed))

        # Audio sensor from the acoustic config (add_audio_sensor,
        # rir.py:275-307).
        spec = habitat.AudioSensorSpec()
        spec.uuid = "audio_sensor"
        spec.enableMaterials = material_json is not None
        if channel is not None:
            spec.channelLayout.type = getattr(
                habitat.sensor.RLRAudioPropagationChannelLayoutType,
                channel.channel_type,
            )
            spec.channelLayout.channelCount = channel.count
        ac = spec.acousticsConfig
        ac.sampleRate = cfg["sampleRate"]
        ac.direct = cfg["direct"]
        ac.indirect = cfg["indirect"]
        ac.diffraction = cfg["diffraction"]
        ac.transmission = cfg["transmission"]
        ac.directSHOrder = cfg["directSHOrder"]
        ac.indirectSHOrder = cfg["indirectSHOrder"]
        ac.unitScale = cfg["unitScale"]
        ac.frequencyBands = cfg["frequencyBands"]
        ac.indirectRayCount = cfg["indirectRayCount"]
        spec.position = [0.0, self.sensor_height, 0.0]
        self.sim.add_sensor(spec)
        self._sensor = self.sim.get_agent(0)._sensors["audio_sensor"]
        if material_json is not None:
            self._sensor.setAudioMaterialsJSON(str(material_json))

    def render(
        self,
        source_position: np.ndarray,
        receiver_position: np.ndarray,
        channel: ChannelModel,
        receiver_rotation: float = 90.0,
    ) -> np.ndarray:
        """Pose agent + source, read one observation → (C, L) float32
        (update_receiver rir.py:335-352 + update_source rir.py:398-414 +
        render_ir rir.py:427-436)."""
        import math

        agent = self.sim.get_agent(0)
        state = agent.get_state()
        state.position = np.asarray(receiver_position, np.float32)
        state.rotation = self._hs.utils.common.quat_from_angle_axis(
            math.radians(receiver_rotation), np.array([0.0, 1.0, 0.0])
        )
        state.sensor_states = {}
        agent.set_state(state, True)
        self._sensor.setAudioSourceTransform(
            np.asarray(source_position, np.float32)
            + np.array([0.0, self.sensor_height, 0.0], np.float32)
        )
        ir = np.asarray(
            self.sim.get_sensor_observations()["audio_sensor"], np.float32
        )
        ir = np.atleast_2d(ir)
        if ir.shape[0] != channel.count:
            raise ValueError(
                f"habitat returned {ir.shape[0]} channels, requested "
                f"{channel.count}"
            )
        return ir

    def close(self) -> None:
        self.sim.close()


def render_rir_bank(
    oracle: RirOracle,
    source_positions: list[np.ndarray],
    receiver_positions: list[np.ndarray],
    channel: ChannelModel,
    receiver_rotations: list[float] | None = None,
    peak_normalize: bool = True,
) -> np.ndarray:
    """All-pairs bank (S, R, C, L) numpy, clipped to the common min length
    and peak-normalised over the whole bank (generate_rir_combination,
    SonicSim_audio.py:342-400). A multiband synthetic oracle takes the
    batched renderer on its ``device``; any other oracle renders pair by
    pair."""
    if isinstance(oracle, SyntheticRirOracle) and oracle.n_bands > 0:
        from .bank_render import render_bank_batched

        return render_bank_batched(
            oracle,
            source_positions,
            receiver_positions,
            channel,
            receiver_rotations,
            peak_normalize,
        )
    rotations = receiver_rotations or [90.0] * len(receiver_positions)
    rirs: list[list[np.ndarray]] = []
    for src in source_positions:
        row = [
            oracle.render(src, rcv, channel, rot)
            for rcv, rot in zip(receiver_positions, rotations)
        ]
        rirs.append(row)
    min_len = min(r.shape[-1] for row in rirs for r in row)
    bank = np.stack(
        [np.stack([r[..., :min_len] for r in row]) for row in rirs]
    ).astype(np.float32)  # (S, R, C, L)
    if peak_normalize:
        peak = np.abs(bank).max()
        if peak > 0:
            bank = bank / peak
    return bank


def save_rir_bank(
    path: str | Path,
    rirs: np.ndarray,
    source_positions: np.ndarray,
    receiver_positions: np.ndarray,
    sample_rate: int = 16000,
    **metadata,
) -> None:
    """Write a bank ``.npz`` in the reference's format: uncompressed, float16
    or float32 ``rirs`` kept as they are (anything else becomes float32)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    rirs = np.asarray(rirs)
    if rirs.dtype not in (np.float16, np.float32):
        rirs = rirs.astype(np.float32)
    np.savez(
        path,
        rirs=rirs,
        source_positions=np.asarray(source_positions, np.float64),
        receiver_positions=np.asarray(receiver_positions, np.float64),
        sample_rate=sample_rate,
        **metadata,
    )
