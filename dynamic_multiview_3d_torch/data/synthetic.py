"""Procedural ShapeNet-style renderings with exact camera poses (numpy only).

The port's own copy of ``dynamic_multiview_3d_tpu/data/synthetic.py``: the
same seeded scene bank (a few shaded cuboids per scene), the same camera
sampling and the same ``example``/``batch`` layout, so a seed gives the
same scenes and poses in both packages. The one difference is the polygon
fill: the original calls OpenCV's anti-aliased ``fillConvexPoly``; this copy
fills each face with a numpy half-plane test (no anti-aliasing), so pixels
along face edges can differ while everything else matches.
"""

from __future__ import annotations

import numpy as np

# Cuboid topology: 8 corners as +-1 signs; 6 faces as corner index quads.
_CORNERS = np.array(
    [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
    np.float32)
_FACES = np.array([
    [0, 1, 3, 2], [4, 5, 7, 6],   # x-, x+
    [0, 1, 5, 4], [2, 3, 7, 6],   # y-, y+
    [0, 2, 6, 4], [1, 3, 7, 5],   # z-, z+
])
_LIGHT = np.array([0.5, 0.3, 0.8], np.float32)
_LIGHT /= np.linalg.norm(_LIGHT)


def look_at_np(pose: np.ndarray) -> np.ndarray:
    """Numpy mirror of ops.pose.look_at_extrinsics."""
    az, el, r = float(pose[0]), float(pose[1]), float(pose[2])
    eye = np.array([r * np.cos(el) * np.cos(az),
                    r * np.cos(el) * np.sin(az),
                    r * np.sin(el)], np.float32)
    center = np.zeros(3, np.float32)
    fwd = center - eye
    fwd = fwd / (np.linalg.norm(fwd) + 1e-9)
    up = np.array([0.0, 0.0, 1.0], np.float32)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right) + 1e-9
    down = np.cross(fwd, right)
    rot = np.stack([right, down, fwd])
    t = np.eye(4, dtype=np.float32)
    t[:3, :3] = rot
    t[:3, 3] = -rot @ eye
    return t


def _rot_z(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def fill_convex_poly(img: np.ndarray, pts: np.ndarray, color) -> None:
    """Fill the convex polygon with integer vertices ``pts`` [V, 2] (x, y)
    into ``img`` [H, W, C] in place: every pixel centre inside or on the
    boundary takes ``color``."""
    h, w = img.shape[:2]
    x_lo, y_lo = np.maximum(pts.min(0), 0)
    x_hi, y_hi = np.minimum(pts.max(0), (w - 1, h - 1))
    if x_lo > x_hi or y_lo > y_hi:
        return
    ys, xs = np.mgrid[y_lo:y_hi + 1, x_lo:x_hi + 1]
    a = pts.astype(np.int64)
    b = np.roll(a, -1, axis=0)
    # edge functions of every (edge, pixel): >= 0 on one side of the edge
    cross = ((b[:, 0] - a[:, 0])[:, None, None] * (ys - a[:, 1, None, None])
             - (b[:, 1] - a[:, 1])[:, None, None] * (xs - a[:, 0, None, None]))
    inside = np.all(cross >= 0, axis=0) | np.all(cross <= 0, axis=0)
    img[y_lo:y_hi + 1, x_lo:x_hi + 1][inside] = color


class SyntheticScenes:
    """Deterministic procedural scene bank.

    render(scene_id, pose, time) -> uint8 [H, W, 3];
    example(index) -> one example (source sequence, targets, poses).
    """

    def __init__(self, num_scenes: int = 512, image_size: int = 128,
                 seq_len: int = 1, num_targets: int = 1, dynamic: bool = False,
                 seed: int = 0, radius: float = 2.0, scene_offset: int = 0,
                 src_views: str = "fixed"):
        self.num_scenes = num_scenes
        self.src_views = src_views
        self.image_size = image_size
        self.seq_len = seq_len
        self.num_targets = num_targets
        self.dynamic = dynamic
        self.seed = seed
        self.radius = radius
        # disjoint scene offsets give geometrically disjoint scene banks
        self.scene_offset = scene_offset
        self.focal = float(image_size)
        self.c = (image_size - 1) / 2.0

    # -- scene construction ------------------------------------------------
    def scene_params(self, scene_id: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, int(scene_id)]))
        n_boxes = int(rng.integers(2, 5))
        return {
            "center": rng.uniform(-0.45, 0.45, (n_boxes, 3)).astype(np.float32),
            "size": rng.uniform(0.12, 0.33, (n_boxes, 3)).astype(np.float32),
            "color": rng.uniform(0.25, 1.0, (n_boxes, 3)).astype(np.float32),
            "spin": rng.uniform(0.15, 0.5, (n_boxes,)).astype(np.float32)
                    * rng.choice([-1.0, 1.0], n_boxes).astype(np.float32),
            "bg": rng.uniform(0.02, 0.12, (3,)).astype(np.float32),
        }

    # -- rasterization -----------------------------------------------------
    def render(self, scene_id: int, pose: np.ndarray, time: float = 0.0
               ) -> np.ndarray:
        p = self.scene_params(scene_id)
        hw = self.image_size
        img = np.empty((hw, hw, 3), np.float32)
        img[:] = p["bg"]
        # vertical background gradient so even empty regions carry pose signal
        img *= np.linspace(0.8, 1.2, hw, dtype=np.float32)[:, None, None]

        w2c = look_at_np(np.asarray(pose, np.float32))
        quads = []  # (depth, poly2d, shade_color)
        for b in range(p["center"].shape[0]):
            spin = p["spin"][b] * time if self.dynamic else 0.0
            rot = _rot_z(spin)
            corners = (_CORNERS * p["size"][b]) @ rot.T + p["center"][b]
            cam = corners @ w2c[:3, :3].T + w2c[:3, 3]
            if np.any(cam[:, 2] <= 0.05):
                continue
            uv = cam[:, :2] / cam[:, 2:3] * self.focal + self.c
            for face in _FACES:
                pts3 = corners[face]
                # outward normal in world space
                normal = np.cross(pts3[1] - pts3[0], pts3[3] - pts3[0])
                nn = np.linalg.norm(normal)
                if nn < 1e-9:
                    continue
                normal /= nn
                if np.dot(normal, pts3[0] - p["center"][b]) < 0:
                    normal = -normal
                # backface cull in camera space
                cam_n = w2c[:3, :3] @ normal
                cam_c = cam[face].mean(0)
                if np.dot(cam_n, cam_c) >= 0:
                    continue
                shade = 0.35 + 0.65 * max(0.0, float(np.dot(normal, _LIGHT)))
                quads.append((float(cam[face][:, 2].mean()),
                              uv[face], p["color"][b] * shade))
        quads.sort(key=lambda q: -q[0])  # far to near
        for _, poly, color in quads:
            fill_convex_poly(img, np.round(poly).astype(np.int32), color)
        return (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)

    # -- pose sampling (view-pair sampler) -----------------------------------
    def sample_poses(self, rng: np.random.Generator, n: int) -> np.ndarray:
        az = rng.uniform(0.0, 2 * np.pi, n)
        el = rng.uniform(0.1, 0.6, n)
        return np.stack(
            [az, el, np.full(n, self.radius)], axis=-1).astype(np.float32)

    def example(self, index: int, raw: bool = False) -> dict:
        """One example: source sequence + target views + poses; ``raw``
        keeps images uint8."""
        scene_id = self.scene_offset + index % self.num_scenes
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed + 1, int(index)]))
        t_len, k = self.seq_len, self.num_targets

        src_poses = self.sample_poses(rng, t_len)
        if t_len > 1 and self.src_views == "orbit":
            # independent cameras per frame, sorted by azimuth
            src_poses = src_poses[np.argsort(src_poses[:, 0])]
        elif t_len > 1:
            # a gentle camera orbit across the sequence (video-like)
            base = src_poses[0]
            drift = rng.uniform(-0.15, 0.15)
            src_poses = np.stack([
                [base[0] + drift * t, base[1], base[2]] for t in range(t_len)
            ]).astype(np.float32)
        tgt_poses = self.sample_poses(rng, k)

        t_final = float(t_len - 1)
        frames = np.stack([
            self.render(scene_id, src_poses[t], time=float(t))
            for t in range(t_len)
        ])
        targets = np.stack([
            self.render(scene_id, tgt_poses[j], time=t_final)
            for j in range(k)
        ])
        convert = (lambda x: x) if raw else to_model
        return {
            "image_seq": convert(frames),           # [T, H, W, 3]
            "src_poses": src_poses,                 # [T, 3]
            "tgt_poses": tgt_poses,                 # [K, 3]
            "tgt_images": convert(targets),         # [K, H, W, 3]
        }

    def batch(self, indices, raw: bool = False) -> dict:
        exs = [self.example(int(i), raw=raw) for i in indices]
        return {k: np.stack([e[k] for e in exs]) for k in exs[0]}


def to_model(img_u8: np.ndarray) -> np.ndarray:
    """uint8 [0,255] -> float32 [-1,1]."""
    return (img_u8.astype(np.float32) / 127.5) - 1.0


def to_uint8(img: np.ndarray) -> np.ndarray:
    return np.clip(np.round((np.asarray(img, np.float32) + 1.0) * 127.5),
                   0, 255).astype(np.uint8)


def smooth_images(rng: np.random.Generator, b: int, t: int, hw: int
                  ) -> np.ndarray:
    """[b, t, hw, hw, 3] float32 sums of random sinusoids in [-1, 1]: inputs
    for comparing two implementations of the model, where a sharp edge
    would turn a tiny flow difference into a large warp difference."""
    y, x = np.mgrid[0:hw, 0:hw].astype(np.float32) / hw
    out = np.zeros((b, t, hw, hw, 3), np.float32)
    for _ in range(4):
        fx, fy = (rng.uniform(-3, 3, (b, t, 1, 1, 3)) for _ in range(2))
        phase = rng.uniform(0, 2 * np.pi, (b, t, 1, 1, 3))
        out += 0.25 * np.sin(2 * np.pi * (fx * x[..., None] + fy * y[..., None])
                             + phase)
    return out


def random_poses(rng: np.random.Generator, b: int, n: int) -> np.ndarray:
    """[b, n, 3] float32 poses (azimuth, elevation, radius 2)."""
    return np.stack([rng.uniform(0, 2 * np.pi, (b, n)),
                     rng.uniform(0.1, 0.6, (b, n)),
                     np.full((b, n), 2.0)], -1).astype(np.float32)
