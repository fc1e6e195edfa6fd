"""Simulator interface + backends.

Counterpart of ``avlmaps_tpu/robot/sim.py`` (host numpy).  The reference
binds directly to habitat-sim (avlmaps/robot/habitat_lang_robot.py:118-146,
utils/habitat_utils.py).  Here the robot talks to a small Simulator protocol
so the same navigation stack runs against habitat when it is installed and
against a kinematic fake otherwise — the fake also serves as the test backend
(the reference has none, SURVEY.md §4).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Protocol, Tuple

import numpy as np

from avlmaps_torch.geometry.transforms import (matrix_to_quat_xyzw,
                                               quat_xyzw_to_matrix)

try:  # pragma: no cover - habitat not present in this image
    import habitat_sim

    HABITAT_AVAILABLE = True
except ImportError:
    habitat_sim = None
    HABITAT_AVAILABLE = False


class Simulator(Protocol):
    def step(self, action: str) -> Any: ...

    def get_agent_tf(self) -> np.ndarray: ...

    def set_agent_tf(self, tf: np.ndarray) -> None: ...

    def get_observation(self) -> Optional[Dict[str, np.ndarray]]: ...


def agent_state_to_tf(position: np.ndarray,
                      rotation_xyzw: np.ndarray) -> np.ndarray:
    """Habitat agent state -> 4x4 tf (reference habitat_utils.py:171-186)."""
    tf = np.eye(4)
    tf[:3, 3] = position
    tf[:3, :3] = quat_xyzw_to_matrix(rotation_xyzw)
    return tf


def tf_to_agent_state(tf: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """4x4 tf -> (position, rotation xyzw)."""
    return tf[:3, 3].copy(), matrix_to_quat_xyzw(tf[:3, :3])


class KinematicSimulator:
    """Kinematic fake: a habitat-convention agent (y up, -z forward) that
    executes move_forward / turn_left / turn_right exactly.

    Used for task replay, controller round-trip tests and any environment
    without habitat-sim.
    """

    def __init__(self, forward_dist: float = 0.1, turn_angle_deg: float = 5.0,
                 init_tf: Optional[np.ndarray] = None):
        self.forward_dist = forward_dist
        self.turn_angle = np.deg2rad(turn_angle_deg)
        self.tf = np.eye(4) if init_tf is None else np.asarray(
            init_tf, np.float64).copy()
        self.steps = 0

    def step(self, action: str):
        if action == "move_forward":
            # habitat: forward is the agent's -z axis
            self.tf[:3, 3] += self.tf[:3, :3] @ np.array([0, 0,
                                                          -self.forward_dist])
        elif action in ("turn_left", "turn_right"):
            sign = 1.0 if action == "turn_left" else -1.0
            c, s = np.cos(sign * self.turn_angle), np.sin(sign
                                                          * self.turn_angle)
            # rotate about the world y (up) axis
            rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
            self.tf[:3, :3] = rot @ self.tf[:3, :3]
        elif action == "stop":
            pass
        else:
            raise ValueError(f"unknown action {action!r}")
        self.steps += 1
        return None

    def get_agent_tf(self) -> np.ndarray:
        return self.tf.copy()

    def set_agent_tf(self, tf: np.ndarray) -> None:
        self.tf = np.asarray(tf, np.float64).copy()

    def get_observation(self):
        return None


def plan_sensor_specs(settings: Dict[str, Any]) -> list:
    """Pure description of the sensor suite the reference's make_cfg builds
    (habitat_utils.py:12-58): per sensor a dict of
    {uuid, sensor_type, resolution, position, orientation}.

    Habitat-free so the spec math is testable without habitat-sim; the
    reference ALWAYS adds a rear third-person colour sensor at
    [0, h, 1.3] pitched down by pi/8 (habitat_utils.py:19-27) — kept here
    behind ``back_color_sensor`` (default True for parity).
    """
    s = settings
    specs = []
    if s.get("back_color_sensor", True):
        specs.append({
            "uuid": "back_color_sensor", "sensor_type": "COLOR",
            "resolution": [s["height"], s["width"]],
            "position": [0.0, s["sensor_height"], 1.3],
            "orientation": [-np.pi / 8, 0.0, 0.0],
        })
    for uuid, stype, key, default in (
            ("color_sensor", "COLOR", "color_sensor", True),
            ("depth_sensor", "DEPTH", "depth_sensor", False),
            ("semantic_sensor", "SEMANTIC", "semantic_sensor", False)):
        if s.get(key, default):
            specs.append({
                "uuid": uuid, "sensor_type": stype,
                "resolution": [s["height"], s["width"]],
                "position": [0.0, s["sensor_height"], 0.0],
                "orientation": [0.0, 0.0, 0.0],
            })
    return specs


def plan_action_space(settings: Dict[str, Any]) -> Dict[str, float]:
    """Action name -> actuation amount (reference habitat_utils.py:60-72).

    Reference quirk preserved bug-for-bug: BOTH turn actions take the
    ``turn_right`` amount (habitat_utils.py:66-70 passes
    settings["turn_right"] to turn_left too)."""
    s = settings
    return {
        "move_forward": float(s.get("move_forward", 0.1)),
        "turn_left": float(s.get("turn_right", s.get("turn_left", 5.0))),
        "turn_right": float(s.get("turn_right", 5.0)),
    }


class HabitatSimulator:
    """Thin habitat-sim binding (reference make_cfg, habitat_utils.py:12-74).

    The sensor/action planning is pure (plan_sensor_specs /
    plan_action_space, tested without habitat); only the translation into
    habitat objects below needs the real dependency."""

    def __init__(self, scene_path: str, sim_setting: Dict[str, Any]):
        if not HABITAT_AVAILABLE:  # pragma: no cover
            raise RuntimeError("habitat_sim is not installed")
        self.sim_setting = dict(sim_setting, scene=scene_path)
        self.sim = habitat_sim.Simulator(
            self._make_cfg())  # pragma: no cover

    def _make_cfg(self):  # pragma: no cover - habitat object construction
        s = self.sim_setting
        sim_cfg = habitat_sim.SimulatorConfiguration()
        sim_cfg.gpu_device_id = 0
        sim_cfg.scene_id = s["scene"]
        sim_cfg.enable_physics = s.get("enable_physics", False)

        type_map = {"COLOR": habitat_sim.SensorType.COLOR,
                    "DEPTH": habitat_sim.SensorType.DEPTH,
                    "SEMANTIC": habitat_sim.SensorType.SEMANTIC}
        sensor_specs = []
        for plan in plan_sensor_specs(s):
            spec = habitat_sim.CameraSensorSpec()
            spec.uuid = plan["uuid"]
            spec.sensor_type = type_map[plan["sensor_type"]]
            spec.resolution = plan["resolution"]
            spec.position = plan["position"]
            spec.orientation = plan["orientation"]
            sensor_specs.append(spec)

        agent_cfg = habitat_sim.agent.AgentConfiguration()
        agent_cfg.sensor_specifications = sensor_specs
        agent_cfg.action_space = {
            name: habitat_sim.agent.ActionSpec(
                name, habitat_sim.agent.ActuationSpec(amount=amount))
            for name, amount in plan_action_space(s).items()
        }
        return habitat_sim.Configuration(sim_cfg, [agent_cfg])

    def step(self, action: str):  # pragma: no cover - live sim call
        if action == "stop":
            return None
        return self.sim.step(action)

    def get_agent_tf(self) -> np.ndarray:  # pragma: no cover - live sim call
        state = self.sim.get_agent(0).get_state()
        quat = state.rotation  # habitat quaternion (w, xyz vector)
        xyzw = np.array([quat.x, quat.y, quat.z, quat.w])
        return agent_state_to_tf(np.asarray(state.position), xyzw)

    def set_agent_tf(self, tf: np.ndarray) -> None:  # pragma: no cover
        import quaternion  # habitat dependency

        pos, xyzw = tf_to_agent_state(tf)
        state = habitat_sim.AgentState()
        state.position = pos
        state.rotation = quaternion.quaternion(xyzw[3], xyzw[0], xyzw[1],
                                               xyzw[2])
        self.sim.get_agent(0).set_state(state)

    def get_observation(self):  # pragma: no cover - live sim call
        return self.sim.get_sensor_observations(0)

    def close(self):  # pragma: no cover - live sim call
        self.sim.close()


def get_position_floor_objects(semantic_scene, position: np.ndarray,
                               height_range: float):  # pragma: no cover
    """GT objects on the same floor as ``position`` from a habitat semantic
    scene (reference habitat_utils.py:228-245): objects whose bbox centre
    lies within ``height_range`` above the agent's floor height."""
    objects = []
    for obj in semantic_scene.objects:
        if obj is None or obj.aabb is None:
            continue
        center_y = float(obj.aabb.center[1])
        if position[1] - 0.5 <= center_y <= position[1] + height_range:
            objects.append(obj)
    return objects


def save_obs(save_dir, obs: dict, frame_id: int,
             obj2cls: Optional[dict] = None) -> None:
    """Persist one observation set in the dataset layout
    (reference habitat_utils.py:97-139): rgb/*.png (BGR on disk),
    depth/*.npy, semantic/*.npy (object ids remapped to classes)."""
    import os

    import cv2

    os.makedirs(f"{save_dir}/rgb", exist_ok=True)
    rgb = obs["color_sensor"][..., :3]
    cv2.imwrite(f"{save_dir}/rgb/{frame_id:06d}.png", rgb[:, :, ::-1])
    if "depth_sensor" in obs:
        os.makedirs(f"{save_dir}/depth", exist_ok=True)
        np.save(f"{save_dir}/depth/{frame_id:06d}.npy",
                np.asarray(obs["depth_sensor"], np.float32))
    if "semantic_sensor" in obs:
        os.makedirs(f"{save_dir}/semantic", exist_ok=True)
        sem = np.asarray(obs["semantic_sensor"])
        if obj2cls:
            lut = np.zeros(int(sem.max()) + 1, np.int32)
            for obj_id, (cls_id, _) in obj2cls.items():
                if obj_id <= sem.max():
                    lut[obj_id] = cls_id
            sem = lut[sem]
        np.save(f"{save_dir}/semantic/{frame_id:06d}.npy", sem)
