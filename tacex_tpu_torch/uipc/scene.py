"""UipcInteractiveScene: a cfg-driven container of mixed entities.

Port of ``tacex_tpu/uipc/scene.py``: entities are declared as a
``{name: cfg}`` dict and built by type, the Franka articulation state, the
analytic rigid primitives, the ``UipcObject``s (all in one ``UipcSim``) and
the ``GelSightSensor``s, on one device; the scene gives dict access,
``keys()``, ``setup``, ``reset`` and an ``update`` that advances the soft
world against the rigid entities, with the dynamic spheres pushed back by
the gel's barrier reaction (``sphere_contact_force``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..assets.robots import FrankaGelSightCfg
from ..core.config import configclass
from ..core.device import DEFAULT_DEVICE, resolve
from ..physics.rigid import articulation as art
from ..physics.rigid.contact import SphereParams
from ..physics.soft.ipc import RigidSdfScene
from ..sensors.gelsight.sensor import GelSightSensor
from ..sensors.gelsight.sensor_cfg import GelSightSensorCfg
from .objects import UipcObject, UipcObjectCfg
from .sim import UipcSim, UipcSimCfg


@configclass
class RigidObjectCfg:
    """Analytic rigid primitive entity (ball, plate, peg)."""

    shape: str = "sphere"  # sphere | box | plane
    size: tuple = (0.005,)  # sphere: (radius,); box: half extents; plane: (nx, ny, nz, d)
    init_pos: tuple = (0.0, 0.0, 0.0)
    mass: float = 0.02
    friction: float = 0.9
    kinematic: bool = False


@configclass
class UipcInteractiveSceneCfg:
    """Capacity knobs; the entities are passed to the scene as a dict."""

    num_envs: int = 1
    env_spacing: float = 0.0  # envs are batched, not tiled in space
    lazy_sensor_update: bool = True
    uipc_sim: UipcSimCfg = None

    def __post_init__(self):
        if self.uipc_sim is None:
            self.uipc_sim = UipcSimCfg()


class _ArticulationEntity:
    """The Franka (+ gripper) articulation's state."""

    def __init__(self, cfg: FrankaGelSightCfg, num_envs: int, device):
        self.cfg = cfg
        self.device = device
        self.reset(num_envs)

    def reset(self, num_envs: int) -> None:
        q0 = torch.as_tensor(np.asarray(self.cfg.default_joint_pos, np.float32), device=self.device)
        self.state = art.GripperArmState.init(num_envs, q0_arm=q0)

    @property
    def joint_pos(self):
        return self.state.q


class _RigidEntity:
    """Analytic rigid primitive with (pos, lin_vel, ang_vel) state."""

    def __init__(self, cfg: RigidObjectCfg, num_envs: int, device):
        self.cfg = cfg
        self.device = device
        # contact parameters exist only for spheres (their inertia divides by r^2)
        self.params = (SphereParams(radius=float(cfg.size[0]), mass=cfg.mass, friction=cfg.friction)
                       if cfg.shape == "sphere" else None)
        f32 = dict(dtype=torch.float32, device=device)
        self._init_pos = torch.as_tensor(np.asarray(cfg.init_pos, np.float32), device=device)
        if cfg.shape == "box":
            self._quat_size = torch.as_tensor(np.asarray((1.0, 0.0, 0.0, 0.0) + tuple(cfg.size), np.float32), **f32)
        elif cfg.shape == "plane":
            self._plane = torch.as_tensor(np.asarray(cfg.size, np.float32), **f32)
        self._gravity = None
        self.reset(num_envs)

    def integrate(self, dt: float, gravity, force=None) -> None:
        """Symplectic Euler of a free sphere; the gel's barrier reaction
        enters as ``force`` (N, 3). Kinematic entities and boxes/planes stay."""
        if self.cfg.kinematic or self.cfg.shape != "sphere":
            return
        if self._gravity is None:
            self._gravity = torch.as_tensor(np.asarray(gravity, np.float32), device=self.device)
        acc = self._gravity if force is None else self._gravity + force / self.cfg.mass
        self.lin_vel = self.lin_vel + dt * acc
        self.pos = self.pos + dt * self.lin_vel

    def reset(self, num_envs: int) -> None:
        self.pos = self._init_pos.expand(num_envs, 3).clone()
        self.lin_vel = torch.zeros((num_envs, 3), device=self.device)
        self.ang_vel = torch.zeros((num_envs, 3), device=self.device)

    def as_scene_collider(self, scene: RigidSdfScene) -> RigidSdfScene:
        """``scene`` with this primitive appended."""
        n = self.pos.shape[0]
        if self.cfg.shape == "sphere":
            sph = torch.cat([self.pos, torch.full((n, 1), self.params.radius, device=self.device)], -1)[:, None]
            return dataclasses.replace(scene, spheres=torch.cat([scene.spheres, sph], 1))
        if self.cfg.shape == "box":
            box = torch.cat([self.pos, self._quat_size.expand(n, 7)], -1)[:, None]
            return dataclasses.replace(scene, boxes=torch.cat([scene.boxes, box], 1))
        if self.cfg.shape == "plane":
            return dataclasses.replace(scene, planes=torch.cat([scene.planes, self._plane.expand(n, 1, 4)], 1))
        raise NotImplementedError(self.cfg.shape)


class UipcInteractiveScene:
    """Scene container: build the entities from their cfgs on ``device`` (the
    card unless the caller passes ``device="cpu"``), look them up by name,
    advance the soft world.

    Usage::

        scene = UipcInteractiveScene(cfg, entities={
            "robot": FRANKA_PANDA_ARM_SINGLE_GSMINI_UIPC_CFG,
            "gel": UipcObjectCfg(...),
            "ball": RigidObjectCfg(shape="sphere", size=(0.005,)),
            "gsmini": gelsight_mini_cfg(),
        }, device="cpu")
        scene.setup()
        scene["gel"].nodal_pos_w
        scene.update(colliders)
    """

    def __init__(self, cfg: UipcInteractiveSceneCfg, entities: dict[str, Any], device=DEFAULT_DEVICE):
        self.cfg = cfg
        self.device = dev = resolve(device)
        n = cfg.num_envs
        sim_cfg = cfg.uipc_sim if cfg.uipc_sim.num_envs == n else cfg.uipc_sim.replace(num_envs=n)
        self.uipc_sim = UipcSim(sim_cfg, device=dev)
        self._articulations: dict[str, _ArticulationEntity] = {}
        self._rigid_objects: dict[str, _RigidEntity] = {}
        self._uipc_objects: dict[str, UipcObject] = {}
        self._sensors: dict[str, GelSightSensor] = {}
        self._sensor_states: dict[str, Any] = {}
        self._extras: dict[str, Any] = {}
        for name, ecfg in entities.items():
            if isinstance(ecfg, UipcObjectCfg):
                self._uipc_objects[name] = UipcObject(ecfg, self.uipc_sim)
            elif isinstance(ecfg, FrankaGelSightCfg):
                self._articulations[name] = _ArticulationEntity(ecfg, n, dev)
            elif isinstance(ecfg, RigidObjectCfg):
                self._rigid_objects[name] = _RigidEntity(ecfg, n, dev)
            elif isinstance(ecfg, GelSightSensorCfg):
                sensor = GelSightSensor(ecfg, num_envs=n, device=dev)
                self._sensors[name] = sensor
                self._sensor_states[name] = sensor.init_state()
            else:
                raise ValueError(f"Unknown entity cfg type for {name!r}: {type(ecfg)}")

    # ------------------------------------------------------------- lifecycle
    def setup(self) -> None:
        """Finalise the soft world (``UipcSim.setup_sim``)."""
        if self.uipc_sim.objects:
            self.uipc_sim.setup_sim()

    def reset(self) -> None:
        n = self.cfg.num_envs
        for a in self._articulations.values():
            a.reset(n)
        for r in self._rigid_objects.values():
            r.reset(n)
        for obj in self._uipc_objects.values():
            obj.write_vertex_positions_to_sim(obj.init_vertex_pos)

    def update(self, colliders: RigidSdfScene | None = None) -> None:
        """Advance the soft world one dt against the rigid entities and the
        extra ``colliders``, then move each dynamic sphere by gravity and the
        gel's barrier reaction on it (action and reaction of one potential)."""
        n = self.cfg.num_envs
        scene = colliders if colliders is not None else RigidSdfScene.empty(n, device=self.device)
        sphere_slot: dict[str, int] = {}
        for name, r in self._rigid_objects.items():
            if r.cfg.shape == "sphere":
                sphere_slot[name] = scene.spheres.shape[1]
            scene = r.as_scene_collider(scene)
        sim = self.uipc_sim
        if sim.objects:
            sim.step(scene)
        dyn = [(name, r) for name, r in self._rigid_objects.items() if r.cfg.shape == "sphere" and not r.cfg.kinematic]
        if not dyn:
            return
        if sim._union_model is not None:
            models = [(sim._union_model, sim._union_state)]
        else:
            models = [(o.model, o.state) for o in sim.objects
                      if o.model is not None and not (o.is_affine_body or o.is_shell)]
        forces = None
        for model, state in models:
            f = model.sphere_contact_force(state, scene)  # (N, S, 3)
            forces = f if forces is None else forces + f
        for name, r in dyn:
            r.integrate(sim.cfg.dt, sim.cfg.gravity, forces[:, sphere_slot[name]] if forces is not None else None)

    # --------------------------------------------------------------- access
    @property
    def articulations(self):
        return self._articulations

    @property
    def rigid_objects(self):
        return self._rigid_objects

    @property
    def uipc_objects(self):
        return self._uipc_objects

    @property
    def sensors(self):
        return self._sensors

    def sensor_state(self, name: str):
        return self._sensor_states[name]

    def set_sensor_state(self, name: str, state) -> None:
        self._sensor_states[name] = state

    def __getitem__(self, key: str):
        """Entity lookup by name."""
        for group in (self._articulations, self._rigid_objects, self._uipc_objects, self._sensors, self._extras):
            if key in group:
                return group[key]
        raise KeyError(
            f"scene entity {key!r} not found; have "
            f"{sorted([*self._articulations, *self._rigid_objects, *self._uipc_objects, *self._sensors])}"
        )

    def keys(self):
        return list(self._articulations) + list(self._rigid_objects) + list(self._uipc_objects) + list(self._sensors)
