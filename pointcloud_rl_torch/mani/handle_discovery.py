# Copy of pointcloud_rl_tpu/mani/handle_discovery.py for the PyTorch port, which imports nothing of that package.
"""Handle discovery from articulation meshes, object-generic.

Parity target: ``mani_skill/mani_skill/env/open_cabinet_door_drawer.py:96-184``
(``_find_handles_from_articulation`` + ``_choose_target_link``) — the
machinery that makes OpenCabinetDoor/Drawer work on ANY PartNet-Mobility
object: find the visual bodies named ``*handle*`` per link, merge their
meshes, take the convex hull, sample its surface, crop to the graspable bar
by the hull's world bbox, and derive the two candidate grasp frames from the
flat direction.  The cabinet/chair models themselves are absent from the
asset snapshot (only buckets ship), so this port works directly off
PartNet-Mobility URDFs + OBJ meshes — no SAPIEN — and is exercised against
the shipped buckets' hinge handles; an OpenCabinet task port becomes
asset-drop-in if cabinet models ever appear.

Implementation notes: SAPIEN render shapes -> a minimal OBJ vertex/face
reader; o3d/trimesh convex hull + surface sampling -> scipy ConvexHull +
area-weighted triangle sampling; poses are ``mani.geometry.Pose``.
"""

from __future__ import annotations

import os.path as osp
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

from .geometry import Pose


# ----------------------------------------------------------------- mesh IO
def read_obj_mesh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Vertices [N,3] + triangle faces [M,3] from a Wavefront OBJ (polygon
    faces are fan-triangulated; v/vt/vn indices resolved to vertex ids)."""
    verts: List[List[float]] = []
    faces: List[List[int]] = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) for tok in line.split()[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def _rpy_to_mat(rpy) -> np.ndarray:
    r, p, y = rpy
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def parse_urdf_handle_meshes(urdf_path: str, scale: float = 1.0,
                             name_filter: str = "handle") -> Dict[str, np.ndarray]:
    """Per-link merged handle-mesh vertices in LINK frame (reference
    open_cabinet_door_drawer.py:102-119: visual bodies whose name contains
    "handle", vertices scaled and moved by the visual's local pose)."""
    root = ET.parse(urdf_path).getroot()
    base = osp.dirname(urdf_path)
    out: Dict[str, np.ndarray] = {}
    for link in root.findall("link"):
        pts = []
        for visual in link.findall("visual"):
            if name_filter not in (visual.get("name") or ""):
                continue
            geom_mesh = visual.find("geometry/mesh")
            if geom_mesh is None:
                continue
            v, _ = read_obj_mesh(osp.join(base, geom_mesh.get("filename")))
            mscale = geom_mesh.get("scale")
            if mscale:
                v = v * np.fromstring(mscale, sep=" ")
            v = v * scale
            origin = visual.find("origin")
            if origin is not None:
                xyz = np.fromstring(origin.get("xyz", "0 0 0"), sep=" ") * scale
                rpy = np.fromstring(origin.get("rpy", "0 0 0"), sep=" ")
                v = v @ _rpy_to_mat(rpy).T + xyz
            pts.append(v)
        if pts:
            out[link.get("name")] = np.concatenate(pts, 0)
    return out


def handle_links_by_joint_type(urdf_path: str, joint_type: str,
                               handle_links: Optional[List[str]] = None) -> List[str]:
    """Links movable by a joint of ``joint_type`` that carry a handle —
    the target-link candidates (reference _choose_target_link:195-205)."""
    root = ET.parse(urdf_path).getroot()
    if handle_links is None:
        handle_links = list(parse_urdf_handle_meshes(urdf_path))
    matches = []
    for joint in root.findall("joint"):
        child = joint.find("child").get("link")
        jt = joint.get("type")
        if jt == "continuous":
            jt = "revolute"
        if jt == joint_type and child in handle_links:
            matches.append(child)
    return matches


# ------------------------------------------------------------ hull sampling
def _convex_hull_sample(vertices: np.ndarray, n: int, rng) -> np.ndarray:
    """Area-weighted surface sampling of the convex hull (the reference's
    ``trimesh.convex.convex_hull(...).sample(500)``)."""
    from scipy.spatial import ConvexHull

    hull = ConvexHull(vertices)
    tris = vertices[hull.simplices]  # [M, 3, 3]
    cross = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    areas = 0.5 * np.linalg.norm(cross, axis=-1)
    probs = areas / areas.sum()
    pick = rng.choice(len(tris), size=n, p=probs)
    u, v = rng.uniform(size=(2, n))
    flip = u + v > 1
    u[flip], v[flip] = 1 - u[flip], 1 - v[flip]
    t = tris[pick]
    return t[:, 0] + u[:, None] * (t[:, 1] - t[:, 0]) + v[:, None] * (t[:, 2] - t[:, 0])


def _build_pose(forward, flat) -> Pose:
    """Reference build_pose (open_cabinet_door_drawer.py:172-176): rotation
    columns [cross(flat, forward), flat, forward]."""
    forward = np.asarray(forward, np.float64)
    flat = np.asarray(flat, np.float64)
    extra = np.cross(flat, forward)
    T = np.eye(4)
    T[:3, :3] = np.array([extra, flat, forward]).T
    return Pose.from_transformation_matrix(T)


def discover_handles(
    urdf_path: str,
    link_poses: Optional[Dict[str, Pose]] = None,
    scale: float = 1.0,
    sample_n: int = 500,
    keep_n: int = 100,
    seed: int = 0,
) -> Dict[str, dict]:
    """Full discovery (reference :123-180): per handle link, convex-hull
    surface points cropped to the grasp bar, in link frame, plus the two
    candidate grasp poses (flat axis +-).

    ``link_poses``: link->world poses at discovery time (identity default —
    PartNet links are expressed in the object frame at zero qpos).
    Returns {link_name: {"points": [<=keep_n, 3] link-frame,
    "grasp_poses": (Pose, Pose), "center": world center, "flat": axis}}.
    """
    rng = np.random.RandomState(seed)
    merged = parse_urdf_handle_meshes(urdf_path, scale=scale)
    out: Dict[str, dict] = {}
    for link_name, verts in merged.items():
        pose = (link_poses or {}).get(link_name, Pose())
        pcd = _convex_hull_sample(verts, sample_n, rng)
        pcd_world = pcd @ np.asarray(pose.to_transformation_matrix())[:3, :3].T + pose.p
        lens = (pcd_world.max(0) - pcd_world.min(0)) / 2
        center = (pcd_world.max(0) + pcd_world.min(0)) / 2
        box_size = lens / 2
        flat = np.array([0, 0, 1.0]) if lens[1] > lens[2] else np.array([0, 1.0, 0])

        region0, region1 = center.copy(), center.copy()
        region1[0] += lens[0]
        region0[0] -= lens[0]
        if lens[1] > lens[2]:
            region0[1] -= box_size[1]
            region0[2] -= lens[2]
            region1[1] += box_size[1]
            region1[2] += lens[2]
        else:
            region0[1] -= lens[1]
            region0[2] -= box_size[2]
            region1[1] += lens[1]
            region1[2] += box_size[2]
        sign = np.all((region0 <= pcd_world) & (pcd_world <= region1), axis=-1)
        pcd_world = pcd_world[sign]
        if len(pcd_world) > keep_n:
            pcd_world = pcd_world[:keep_n]
        inv = pose.inv()
        points_local = pcd_world @ np.asarray(inv.to_transformation_matrix())[:3, :3].T + inv.p

        out[link_name] = {
            "points": points_local,
            "grasp_poses": (inv * _build_pose([1, 0, 0], flat),
                            inv * _build_pose([1, 0, 0], -flat)),
            "center": center,
            "flat": flat,
        }
    return out
