"""Editor: selection, transform gizmo math, scene hierarchy operations.

Role-equivalent to the reference's editor layer (arkose/scene/editor/
EditorScene.h:11-41 — selected-object tracking, EditorGizmo.h:10-28 —
ImGuizmo-driven translate/rotate/scale, icon raycast picking): UI toolkit-
independent editor logic. A front end (notebook widget, web dashboard,
terminal) calls these with pick results and drag vectors.
"""

from __future__ import annotations

import dataclasses
from enum import Enum

import numpy as np

from arkoserenderer.core import mathx as mx


class GizmoMode(Enum):
    TRANSLATE = "translate"
    ROTATE = "rotate"
    SCALE = "scale"


@dataclasses.dataclass
class EditorScene:
    """Selection + object manipulation over a host Scene."""

    scene: object  # scene.Scene

    def __post_init__(self):
        self.selected: int | None = None  # instance index
        self.gizmo_mode = GizmoMode.TRANSLATE

    # -- selection -----------------------------------------------------------

    def select_from_pick(self, pick_result: dict):
        """Feed Renderer.pick() output (PickingNode -> editor selection)."""
        inst = pick_result.get("instance", -1)
        self.selected = inst if inst >= 0 else None
        return self.selected

    def selected_transform(self) -> np.ndarray | None:
        if self.selected is None:
            return None
        return self.scene.instances[self.selected][1]

    # -- manipulation -------------------------------------------------------------

    def set_transform(self, world: np.ndarray):
        assert self.selected is not None
        sid, old, prev, clip, lod_band = self.scene.instances[self.selected]
        self.scene.instances[self.selected] = (
            sid, np.asarray(world, np.float32), old, clip, lod_band
        )

    def translate(self, delta):
        t = self.selected_transform()
        assert t is not None
        new = t.copy()
        new[:3, 3] += np.asarray(delta, np.float32)
        self.set_transform(new)

    def rotate(self, axis, angle: float):
        t = self.selected_transform()
        assert t is not None
        q = mx.quat_from_axis_angle(np.asarray(axis, np.float32), angle, xp=np)
        r = np.asarray(mx.quat_to_mat3(q, xp=np))
        new = t.copy()
        new[:3, :3] = r @ t[:3, :3]
        self.set_transform(new)

    def scale(self, factor: float):
        t = self.selected_transform()
        assert t is not None
        new = t.copy()
        new[:3, :3] *= factor
        self.set_transform(new)

    def delete_selected(self):
        """Remove the selected instance (scene rebuild required after)."""
        assert self.selected is not None
        self.scene.instances.pop(self.selected)
        self.selected = None


def gizmo_axis_drag(
    camera,
    axis_world: np.ndarray,
    object_pos: np.ndarray,
    mouse_from: np.ndarray,
    mouse_to: np.ndarray,
) -> float:
    """Translate-gizmo math: project a screen drag onto a world axis and
    return the world-space distance along it (ImGuizmo translate behavior).
    Mouse coords in pixels."""
    vp = camera.projection_matrix() @ camera.view_matrix()

    def to_screen(p):
        clip = mx.transform_points_h(vp, p[None], xp=np)[0]
        w = max(abs(clip[3]), 1e-8)
        return np.array([
            (clip[0] / w * 0.5 + 0.5) * camera.viewport[0],
            (0.5 - clip[1] / w * 0.5) * camera.viewport[1],
        ])

    a0 = to_screen(object_pos)
    a1 = to_screen(object_pos + axis_world)
    axis_screen = a1 - a0
    denom = float(axis_screen @ axis_screen)
    if denom < 1e-8:
        return 0.0  # axis points at the camera
    drag = np.asarray(mouse_to, np.float32) - np.asarray(mouse_from, np.float32)
    return float(drag @ axis_screen) / denom
