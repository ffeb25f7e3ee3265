"""Headless software renderer + camera/input for the demos.

The reference demos render with a gfx/glutin pipeline: a flat-color MVP
vertex shader + constant-color fragment shader (mgf_demo/shaders/
balls_vs.glsl, balls_fs.glsl), a perspective camera driven by WASD/mouse
(mgf_demo/input.rs:81-110, balls.rs:98-101), and per-shape draw calls
(mgf_demo/world.rs:296-392: spheres, capsules, terrain triangles).

There is no display on an accelerator host, so this module reproduces that
pipeline as a small z-buffered numpy rasterizer writing PPM frames:

* :class:`Camera` + :func:`view_proj` — the MVP of balls_vs.glsl,
* :func:`apply_input` — the WASD + mouse-look mapping of input.rs,
* :func:`render_world` — flat-color terrain triangles (barycentric
  rasterization), spheres as depth-tested perspective discs, capsules as
  swept sphere samples (the same visual the reference's low-poly meshes
  give at demo scale),
* :func:`save_ppm` — frame output (view with any image tool).

Pure numpy on host — rendering is presentation, not physics, so it stays
off the device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np


# ---------------------------------------------------------------------------
# camera + input (input.rs:81-110; balls.rs:98-101 WASD bindings)
# ---------------------------------------------------------------------------

class Camera(NamedTuple):
    pos: tuple          # (x, y, z) eye position
    yaw: float          # radians about +y; 0 looks down -z
    pitch: float        # radians; positive looks up
    fov: float = math.radians(60.0)
    near: float = 0.1
    far: float = 500.0


def camera_forward(cam: Camera):
    cp = math.cos(cam.pitch)
    return np.array([-math.sin(cam.yaw) * cp,
                     math.sin(cam.pitch),
                     -math.cos(cam.yaw) * cp], np.float64)


def apply_input(cam: Camera, keys=(), mouse=(0.0, 0.0), dt=1.0 / 60.0,
                speed=20.0, sensitivity=0.005) -> Camera:
    """One tick of the reference's input mapping (input.rs:81-110):
    WASD strafes in the yaw plane, mouse deltas turn the camera."""
    yaw = cam.yaw - mouse[0] * sensitivity
    pitch = float(np.clip(cam.pitch - mouse[1] * sensitivity,
                          -0.49 * math.pi, 0.49 * math.pi))
    fwd = np.array([-math.sin(yaw), 0.0, -math.cos(yaw)])
    right = np.array([math.cos(yaw), 0.0, -math.sin(yaw)])
    move = np.zeros(3)
    if "w" in keys:
        move += fwd
    if "s" in keys:
        move -= fwd
    if "d" in keys:
        move += right
    if "a" in keys:
        move -= right
    pos = np.asarray(cam.pos, np.float64) + move * (speed * dt)
    return cam._replace(pos=tuple(pos), yaw=yaw, pitch=pitch)


def view_proj(cam: Camera, width: int, height: int):
    """4x4 view-projection matrix — the MVP of balls_vs.glsl."""
    cy, sy = math.cos(cam.yaw), math.sin(cam.yaw)
    cp, sp = math.cos(cam.pitch), math.sin(cam.pitch)
    # rotate world by -yaw about y then -pitch about x, translate by -pos
    ry = np.array([[cy, 0, -sy], [0, 1, 0], [sy, 0, cy]])
    rx = np.array([[1, 0, 0], [0, cp, sp], [0, -sp, cp]])
    r = rx @ ry.T
    view = np.eye(4)
    view[:3, :3] = r
    view[:3, 3] = -r @ np.asarray(cam.pos, np.float64)
    f = 1.0 / math.tan(cam.fov / 2.0)
    aspect = width / height
    proj = np.zeros((4, 4))
    proj[0, 0] = f / aspect
    proj[1, 1] = f
    proj[2, 2] = (cam.far + cam.near) / (cam.near - cam.far)
    proj[2, 3] = 2 * cam.far * cam.near / (cam.near - cam.far)
    proj[3, 2] = -1.0
    return proj @ view


# ---------------------------------------------------------------------------
# rasterizer
# ---------------------------------------------------------------------------

class Frame:
    def __init__(self, width=640, height=480, background=(24, 28, 38)):
        self.w, self.h = width, height
        self.color = np.empty((height, width, 3), np.uint8)
        self.color[:] = background
        self.depth = np.full((height, width), np.inf, np.float64)


def _project(mvp, pts):
    """(N,3) world -> (N,2) pixel + (N,) view depth + (N,) w; w<=0 behind."""
    n = pts.shape[0]
    hom = np.concatenate([pts, np.ones((n, 1))], axis=1) @ mvp.T
    w = hom[:, 3]
    safe = np.where(np.abs(w) < 1e-9, 1e-9, w)
    ndc = hom[:, :3] / safe[:, None]
    return ndc, w


def _to_pixels(ndc, w, h):
    px = (ndc[:, 0] * 0.5 + 0.5) * (w - 1)
    py = (0.5 - ndc[:, 1] * 0.5) * (h - 1)
    return px, py


def draw_triangles(frame: Frame, mvp, verts, faces, color=(90, 110, 90)):
    """Flat-color z-buffered triangles (the terrain draw of world.rs:372-
    389). Bounding-box barycentric fill per face — terrain is a handful of
    triangles, so plain loops are fine on host."""
    ndc, w = _project(mvp, np.asarray(verts, np.float64))
    px, py = _to_pixels(ndc, frame.w, frame.h)
    depth = ndc[:, 2]
    color = np.asarray(color, np.uint8)
    for (i, j, k) in np.asarray(faces, np.int64):
        if w[i] <= 0 or w[j] <= 0 or w[k] <= 0:
            continue
        xs = np.array([px[i], px[j], px[k]])
        ys = np.array([py[i], py[j], py[k]])
        zs = np.array([depth[i], depth[j], depth[k]])
        x0, x1 = int(max(0, xs.min())), int(min(frame.w - 1, xs.max())) + 1
        y0, y1 = int(max(0, ys.min())), int(min(frame.h - 1, ys.max())) + 1
        if x0 >= x1 or y0 >= y1:
            continue
        gx, gy = np.meshgrid(np.arange(x0, x1), np.arange(y0, y1))
        d = ((ys[1] - ys[2]) * (xs[0] - xs[2])
             + (xs[2] - xs[1]) * (ys[0] - ys[2]))
        if abs(d) < 1e-12:
            continue
        l0 = ((ys[1] - ys[2]) * (gx - xs[2]) + (xs[2] - xs[1])
              * (gy - ys[2])) / d
        l1 = ((ys[2] - ys[0]) * (gx - xs[2]) + (xs[0] - xs[2])
              * (gy - ys[2])) / d
        l2 = 1.0 - l0 - l1
        inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0)
        z = l0 * zs[0] + l1 * zs[1] + l2 * zs[2]
        tile_d = frame.depth[y0:y1, x0:x1]
        hit = inside & (z < tile_d)
        tile_d[hit] = z[hit]
        frame.color[y0:y1, x0:x1][hit] = color


def draw_spheres(frame: Frame, mvp, centers, radii, color=(224, 96, 64)):
    """Depth-tested perspective discs (the sphere draw of world.rs:296-340;
    at demo scale the reference's low-poly icospheres read the same)."""
    centers = np.asarray(centers, np.float64).reshape(-1, 3)
    radii = np.broadcast_to(np.asarray(radii, np.float64).ravel(),
                            (centers.shape[0],))
    ndc, w = _project(mvp, centers)
    px, py = _to_pixels(ndc, frame.w, frame.h)
    # perspective pixel radius: r / (w * tan(fov/2)) * (h/2); recover the
    # projection scale from the mvp's [1,1] block applied to a unit offset
    scale = abs(mvp[1, 1]) if abs(mvp[1, 1]) > 1e-9 else 1.0
    order = np.argsort(-w)                      # far-to-near
    color = np.asarray(color, np.uint8)
    for b in order:
        if w[b] <= 0:
            continue
        pr = radii[b] * scale / w[b] * (frame.h / 2)
        if pr < 0.5:
            pr = 0.5
        x0 = int(max(0, px[b] - pr))
        x1 = int(min(frame.w - 1, px[b] + pr)) + 1
        y0 = int(max(0, py[b] - pr))
        y1 = int(min(frame.h - 1, py[b] + pr)) + 1
        if x0 >= x1 or y0 >= y1:
            continue
        gx, gy = np.meshgrid(np.arange(x0, x1), np.arange(y0, y1))
        rr = ((gx - px[b]) ** 2 + (gy - py[b]) ** 2) / (pr * pr)
        inside = rr <= 1.0
        z = ndc[b, 2]
        tile_d = frame.depth[y0:y1, x0:x1]
        hit = inside & (z < tile_d)
        tile_d[hit] = z
        # cheap lambert-ish shading by disc height
        lum = (1.15 - 0.45 * np.sqrt(np.clip(rr, 0, 1)))[hit]
        frame.color[y0:y1, x0:x1][hit] = np.clip(
            color[None, :] * lum[:, None], 0, 255).astype(np.uint8)


def draw_capsules(frame: Frame, mvp, a, d, radii, color=(96, 160, 224),
                  samples=5):
    """Capsules as swept sphere samples along the segment (world.rs renders
    a cylinder+caps mesh; the swept-disc union is the same silhouette)."""
    a = np.asarray(a, np.float64).reshape(-1, 3)
    d = np.asarray(d, np.float64).reshape(-1, 3)
    for t in np.linspace(0.0, 1.0, samples):
        draw_spheres(frame, mvp, a + d * t, radii, color)


def save_ppm(path: str, frame: Frame):
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (frame.w, frame.h))
        f.write(frame.color.tobytes())


def render_world(world, width=640, height=480, camera: Camera = None,
                 path: str = None) -> Frame:
    """Render a :class:`mgf_tpu.world.World` snapshot (world.rs:296-392)."""
    from mgf_tpu.world import shape_view
    b = world.bodies
    x = np.stack([np.asarray(b.x.x), np.asarray(b.x.y),
                  np.asarray(b.x.z)], axis=1)
    if camera is None:
        target = x.mean(axis=0)
        camera = Camera(pos=(target[0], target[1] + 6.0, target[2] + 40.0),
                        yaw=0.0, pitch=-0.15)
    frame = Frame(width, height)
    mvp = view_proj(camera, width, height)
    if world.terrain is not None:
        t = world.terrain
        verts = []
        faces = []
        for i in range(np.asarray(t.a.x).shape[0]):
            base = len(verts)
            for p in (t.a, t.b, t.c):
                verts.append([float(np.asarray(p.x)[i]),
                              float(np.asarray(p.y)[i]),
                              float(np.asarray(p.z)[i])])
            faces.append([base, base + 1, base + 2])
        draw_triangles(frame, mvp, np.asarray(verts), np.asarray(faces))
    st = np.asarray(b.shape_type)
    r = np.asarray(b.shape_r, np.float64)
    dyn = np.asarray(b.inv_mass) >= 0          # draw everything
    sph = dyn & (st == 0)
    if sph.any():
        draw_spheres(frame, mvp, x[sph], r[sph])
    cap = dyn & (st == 1)
    if cap.any():
        sv = shape_view(world.bodies)
        ca = np.stack([np.asarray(sv.cap.a.x), np.asarray(sv.cap.a.y),
                       np.asarray(sv.cap.a.z)], 1)[cap]
        cd = np.stack([np.asarray(sv.cap.d.x), np.asarray(sv.cap.d.y),
                       np.asarray(sv.cap.d.z)], 1)[cap]
        draw_capsules(frame, mvp, ca, cd, r[cap])
    if path:
        save_ppm(path, frame)
    return frame
