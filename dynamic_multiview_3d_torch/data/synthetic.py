"""Procedural ShapeNet-style renderings with exact camera poses (numpy only).

The port's own copy of ``dynamic_multiview_3d_tpu/data/synthetic.py``: the
same seeded scene bank (a few shaded cuboids per scene), the same camera
sampling and the same ``example``/``batch`` layout, so a seed gives the
same scenes, poses and pixels in both packages. The original fills each
face with ``cv2.fillConvexPoly(..., lineType=cv2.LINE_AA)``; on a float32
image OpenCV drops the anti-aliasing and draws with ``LINE_8``, which
``fill_convex_poly`` copies in numpy (OpenCV's ``FillConvexPoly``: 8-connected
edges, then a fixed-point scanline fill), so no OpenCV is needed.
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


XY_SHIFT = 16                 # OpenCV's fixed-point fraction bits
_HALF = 1 << (XY_SHIFT - 1)


def _i64(v: int) -> int:
    """``v`` wrapped to int64, as OpenCV's int64 arithmetic wraps."""
    return (v + (1 << 63)) % (1 << 64) - (1 << 63)


def _cdiv(a: int, b: int) -> int:
    """C's integer division (truncation toward zero) for b > 0."""
    return a // b if a >= 0 else -(-a // b)


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine`` of the segment to the w x h image: the clipped
    end points, or None where no part of it lies in the image."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8
    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (x1, y1, x2, y2) if (c1 | c2) == 0 else None


def _line_pixels(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """The pixels (xs, ys) OpenCV's 8-connected ``Line`` sets: the segment
    clipped (``_clip_line``), then Bresenham from its left end; the minor
    coordinate after k steps is ceil((2 minor k - major) / (2 major))."""
    inside = (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h)
    if not inside:
        clipped = _clip_line(w, h, x1, y1, x2, y2)
        if clipped is None:
            return None
        x1, y1, x2, y2 = clipped
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, abs(y2 - y1)
    sy = -1 if y2 < y1 else 1
    major, minor = max(dx, dy), min(dx, dy)
    k = np.arange(major + 1, dtype=np.int64)
    c = -((major - 2 * minor * k) // (2 * major)) if major else k
    if dy > dx:
        return x1 + c, y1 + sy * k
    return x1 + k, y1 + sy * c


def _scanline_spans(xs: list, ys: list, w: int, h: int) -> list:
    """OpenCV's scanline fill of the convex polygon (``FillConvexPoly``
    after its edges are drawn): the two edge chains walked down from the
    top vertex in 16-bit fixed point. Returns one (y0, y1, x_a, dx_a, x_b,
    dx_b) per stretch of rows between vertices: row y0 <= y < y1 spans the
    chains' x_a + dx_a (y - y0) and x_b + dx_b (y - y0)."""
    n = len(xs)
    imin = min(range(n), key=ys.__getitem__)       # the first top vertex
    ymax = min(max(ys), h - 1)
    idx, di = [imin, imin], (1, n - 1)
    ye = [ys[imin]] * 2
    x, dx = [-(1 << XY_SHIFT)] * 2, [0, 0]
    y, edges, spans = ye[0], n, []
    while y <= ymax:
        for i in (0, 1):
            if y < ye[i]:
                continue
            idx0 = idx[i]
            j = (idx0 + di[i]) % n
            while True:                             # for (; edges-- > 0; )
                edges -= 1
                if edges < 0:
                    break
                ty = ys[j]
                if ty > y:
                    xs0, xe = xs[idx0] << XY_SHIFT, xs[j] << XY_SHIFT
                    ye[i], idx[i], x[i] = ty, j, xs0
                    dx[i] = _i64(_cdiv(2 * (xe - xs0) + (ty - y),
                                       2 * (ty - y)))
                    break
                idx0, j = j, (j + di[i]) % n
        if edges < 0:
            break
        y_end = min(ye[0], ye[1], ymax + 1)
        spans.append((y, y_end, x[0], dx[0], x[1], dx[1]))
        x = [_i64(x[i] + dx[i] * (y_end - y)) for i in (0, 1)]
        y = y_end
    return spans


def fill_convex_poly(img: np.ndarray, pts: np.ndarray, color) -> None:
    """``cv2.fillConvexPoly(img, pts, color, lineType=cv2.LINE_AA)`` on a
    float32 image, where OpenCV draws with ``LINE_8``: fill the convex
    polygon with integer vertices ``pts`` [V, 2] (x, y) into ``img``
    [H, W, C] in place, bit for bit as OpenCV does. Each edge is drawn as
    an 8-connected line, then the rows between the two edge chains are
    filled from their fixed-point x positions rounded half up; everything
    is clipped to the image. Fewer than three vertices, or a polygon
    wholly off the image, draws its edges only."""
    h, w = img.shape[:2]
    xs, ys = ([int(v) for v in col] for col in np.asarray(pts).T)
    n = len(xs)
    lines = [_line_pixels(w, h, xs[i - 1], ys[i - 1], xs[i], ys[i])
             for i in range(n)]
    lines = [line for line in lines if line is not None]
    if lines:
        img[np.concatenate([ln[1] for ln in lines]),
            np.concatenate([ln[0] for ln in lines])] = color
    if n < 3 or max(xs) < 0 or max(ys) < 0 or min(xs) >= w or min(ys) >= h:
        return
    spans = _scanline_spans(xs, ys, w, h)
    if not spans or max(spans[0][0], 0) >= spans[-1][1]:
        return
    r0, r1 = max(spans[0][0], 0), spans[-1][1]
    spans = np.array(spans, np.int64)
    rows = np.arange(r0, r1, dtype=np.int64)
    y0, _, xa, dxa, xb, dxb = spans[np.searchsorted(spans[:, 0], rows,
                                                    "right") - 1].T
    a = xa + dxa * (rows - y0)                  # wraps as OpenCV's int64 does
    b = xb + dxb * (rows - y0)
    lo = (np.minimum(a, b) + _HALF) >> XY_SHIFT
    hi = (np.maximum(a, b) + _HALF) >> XY_SHIFT
    c0, c1 = max(int(lo.min()), 0), min(int(hi.max()), w - 1) + 1
    cols = np.arange(c0, max(c1, c0), dtype=np.int64)
    img[r0:r1, c0:c1][(cols >= lo[:, None]) & (cols <= hi[:, None])] = color


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
