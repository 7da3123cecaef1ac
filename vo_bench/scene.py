"""The benchmark's traffic generator: synthetic KITTI-like drives.

Two forms of one scene model:

* a frozen NumPy copy of the port's generator (`make_trajectory`,
  `scene_along_path`, `_texture`, `_raycast` of
  `sdv_loam_tpu_torch/data/synthetic.py`), kept here so that later changes
  to the port cannot move the benchmark's inputs; the tests hold the
  renderer below to it;
* `render_lanes`, the same ray cast as plain PyTorch in float64 on the
  card: every lane's frames in a few large calls, copied to host memory
  as the KITTI reader hands them to the system (float32 images, (N, 3)
  float32 clouds in the LiDAR frame).

Each lane drives a canyon of its own: the traffic fixes one drive per
lane (textures from its `scene_seed` and the drive's index, yaw rates
spread between the two scenes of the repo's old benchmark, +0.004 and
-0.006 rad/frame), drive d on lane d. The seed changes none of it: the
port's trajectories, and with them its captured programs and its memory
peak, move with a drive's lane (PERF.md), so every seed asks for the same
work in the same order.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# texture seeds of the ground, the first wall segment and the far wall in
# the port's generator (`synthetic.scene_along_path`)
PORT_TEXTURE_SEEDS = (11, 100, 44)


@dataclasses.dataclass
class Plane:
    p0: np.ndarray
    n: np.ndarray
    eu: np.ndarray
    ev: np.ndarray
    bounds: tuple | None
    tex_seed: int
    contrast: float = 1.0


# ---------------------------------------------------------------------------
# frozen NumPy generator
# ---------------------------------------------------------------------------

def texture_components(seed):
    """The 60 plane waves of one texture: (amp, r, cos th, sin th, phase)
    per component, and the normalisation of the unattenuated sum."""
    rng = np.random.default_rng(seed)
    comps, var = [], 0.0
    for k in range(12):
        amp = 1.0 / (1.08 ** k)
        for _ in range(5):
            r = rng.uniform(0.4, 1.1) * (1.7 ** k) * 0.1
            th = rng.uniform(0, 2 * np.pi)
            ph = rng.uniform(0, 2 * np.pi)
            comps.append((amp, r, np.cos(th), np.sin(th), ph))
            var += amp * amp * 0.5
    return np.array(comps), 0.373 / np.sqrt(var)


def _texture(u, v, seed, footprint=0.0, contrast=1.0):
    """Band-limited procedural texture in [10, 245], each wave attenuated
    by the pixel footprint (a Gaussian aperture)."""
    comps, norm = texture_components(seed)
    out = np.zeros_like(u)
    s2 = np.square(footprint)
    for amp, r, c, s, ph in comps:
        att = np.exp(-0.5 * r * r * s2)
        out = out + (amp * att) * np.sin(r * c * u + r * s * v + ph)
    out = out * norm * contrast
    return np.clip(127.0 + 110.0 * out, 10.0, 245.0)


def make_trajectory(n_frames, step=1.0, yaw_rate=0.004):
    """(n, 4, 4) T_world<-cam: a forward drive turning at `yaw_rate` per
    frame (camera x right, y down, z forward)."""
    poses = np.zeros((n_frames, 4, 4))
    T = np.eye(4)
    c, s = np.cos(yaw_rate), np.sin(yaw_rate)
    Tstep = np.eye(4)
    Tstep[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    Tstep[:3, 3] = [0.0, 0.0, step]
    for i in range(n_frames):
        poses[i] = T
        T = T @ Tstep
    return poses


def scene_along_path(poses_wc, half_width=9.0, seg_len=20.0,
                     cam_height=1.65, wall_top=9.0, ground_contrast=1.0,
                     seeds=PORT_TEXTURE_SEEDS):
    """A winding canyon: the ground, wall segments every `seg_len` metres
    on both sides of the path, facing it, and a far wall past its end.
    `seeds`: the ground's texture seed, the first wall segment's (each
    later segment the next), the far wall's."""
    pos = poses_wc[:, :3, 3]
    fwd = poses_wc[:, :3, 2]
    arc = np.concatenate([[0.0], np.cumsum(
        np.linalg.norm(np.diff(pos, axis=0), axis=1))])
    planes = [Plane(np.array([0.0, cam_height, 0.0]),
                    np.array([0.0, -1.0, 0.0]), np.array([1.0, 0.0, 0.0]),
                    np.array([0.0, 0.0, 1.0]), None, seeds[0],
                    contrast=ground_contrast)]
    up = np.array([0.0, -1.0, 0.0])
    seed = seeds[1]
    s = 0.0
    while s < arc[-1] + seg_len:
        i = int(np.searchsorted(arc, min(s + 0.5 * seg_len, arc[-1])))
        i = min(i, len(pos) - 1)
        c = pos[i]
        h = fwd[i] * np.array([1.0, 0.0, 1.0])
        h = h / max(np.linalg.norm(h), 1e-9)
        lat = np.cross(up, h)
        half = 0.5 * seg_len + 0.01
        for side in (-1.0, 1.0):
            planes.append(Plane(c + side * half_width * lat, -side * lat,
                                h.copy(), up.copy(),
                                (-half, half, -cam_height, wall_top), seed))
            seed += 1
        s += seg_len
    end = pos[-1] + fwd[-1] * 120.0
    planes.append(Plane(end, -fwd[-1] / max(np.linalg.norm(fwd[-1]), 1e-9),
                        np.cross(up, fwd[-1]), up.copy(), None, seeds[2]))
    return planes


# bounded planes farther than this from the ray origin are not cast
CULL_M = 250.0


def _raycast(scene, origins, dirs, t_min=0.15, t_max=400.0, px_scale=0.0):
    """(t (N,), intensity (N,)) of rays from `origins` ((3,) or (N, 3))
    along `dirs` (N, 3); t = inf where nothing is hit. With `px_scale`
    (the angular pixel size) the texture is sampled with the pixel's
    footprint on the surface."""
    origins = np.broadcast_to(origins, dirs.shape)
    best_t = np.full(dirs.shape[0], np.inf)
    best_i = np.zeros(dirs.shape[0])
    dnorm = np.linalg.norm(dirs, axis=-1)
    cam = origins[0]
    scene = [pl for pl in scene
             if pl.bounds is None or np.linalg.norm(pl.p0 - cam) < CULL_M]
    for pl in scene:
        denom = dirs @ pl.n
        num = (pl.p0 - origins) @ pl.n
        with np.errstate(divide="ignore", invalid="ignore"):
            t = num / denom
            ok = (denom < -1e-9) & (t > t_min) & (t < t_max)
            t_safe = np.where(ok, t, 1.0)
            hit = origins + t_safe[:, None] * dirs
            u = (hit - pl.p0) @ pl.eu
            v = (hit - pl.p0) @ pl.ev
        if pl.bounds is not None:
            umin, umax, vmin, vmax = pl.bounds
            ok &= (u >= umin) & (u <= umax) & (v >= vmin) & (v <= vmax)
        closer = ok & (t < best_t)
        if np.any(closer):
            if px_scale > 0.0:
                cosi = np.abs(denom[closer]) / np.maximum(dnorm[closer], 1e-9)
                fp = (t[closer] * px_scale) / np.maximum(cosi, 0.05)
            else:
                fp = 0.0
            best_t[closer] = t[closer]
            best_i[closer] = _texture(u[closer], v[closer], pl.tex_seed, fp,
                                      contrast=pl.contrast)
    return best_t, best_i


# ---------------------------------------------------------------------------
# the deployment's camera, LiDAR and drives
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Rig:
    """Camera (pinhole at level 0) and LiDAR (ring geometry, T_cam<-lidar)."""

    w: int
    h: int
    fx: float
    fy: float
    cx: float
    cy: float
    T_cam_lidar: np.ndarray
    n_scan: int
    horizon_scan: int
    ang_res_x: float
    ang_res_y: float
    ang_bottom: float
    lidar_stride: int

    def camera_dirs(self):
        """(h*w, 3) camera-frame ray directions with z = 1."""
        xx, yy = np.meshgrid(np.arange(self.w, dtype=np.float64),
                             np.arange(self.h, dtype=np.float64))
        dx = (xx - self.cx) / self.fx
        dy = (yy - self.cy) / self.fy
        return np.stack([dx, dy, np.ones_like(dx)], -1).reshape(-1, 3)

    def lidar_dirs(self):
        """(rings * columns, 3) unit directions in the LiDAR frame (x
        forward, y left, z up), every `lidar_stride`-th column."""
        rows = np.arange(self.n_scan, dtype=np.float64)
        cols = np.arange(0, self.horizon_scan, self.lidar_stride,
                         dtype=np.float64)
        vert = np.deg2rad(rows * self.ang_res_y - self.ang_bottom)
        horiz = np.deg2rad((self.horizon_scan / 2 - cols) * self.ang_res_x
                           + 90.0)
        v, h = np.meshgrid(vert, horiz, indexing="ij")
        return np.stack([np.cos(v) * np.sin(h), np.cos(v) * np.cos(h),
                         np.sin(v)], -1).reshape(-1, 3)


@dataclasses.dataclass
class Drive:
    poses_wc: np.ndarray
    scene: list
    yaw_rate: float


def lane_drives(lanes, n_frames, traffic):
    """The lanes' drives of one run, drive d on lane d. The traffic fixes
    the `lanes` drives: drive d turns at a rate evenly spaced in magnitude
    between the traffic's two yaw rates, alternating in sign, through a
    canyon whose textures come from (the traffic's `scene_seed`, d)."""
    y0, y1 = traffic["yaw_rates"]
    mags = np.linspace(abs(y0), abs(y1), lanes)
    drives = []
    for d, m in enumerate(mags):
        yaw = float(np.copysign(m, (y0, y1)[d % 2]))
        tex = np.random.SeedSequence([traffic["scene_seed"], d]
                                     ).generate_state(3)
        poses = make_trajectory(n_frames, step=traffic["step_m"],
                                yaw_rate=yaw)
        scene = scene_along_path(
            poses, half_width=traffic["half_width_m"],
            ground_contrast=traffic["ground_contrast"],
            seeds=tuple(int(x) for x in tex))
        drives.append(Drive(poses, scene, yaw))
    return drives


def render_numpy(rig, drive, i):
    """Frame i of a drive with the frozen NumPy generator: (image (h, w)
    float32, cloud (N, 3) float32)."""
    T = drive.poses_wc[i]
    d = rig.camera_dirs() @ T[:3, :3].T
    t, inten = _raycast(drive.scene, T[:3, 3], d, px_scale=1.0 / rig.fx)
    img = np.where(np.isfinite(t), inten, 0.0).reshape(rig.h, rig.w)
    T_wl = T @ rig.T_cam_lidar
    dl = rig.lidar_dirs()
    t, _ = _raycast(drive.scene, T_wl[:3, 3], dl @ T_wl[:3, :3].T,
                    t_min=1.0, t_max=80.0)
    hit = np.isfinite(t)
    return img.astype(np.float32), (dl[hit] * t[hit, None]).astype(np.float32)


# ---------------------------------------------------------------------------
# the renderer on the card
# ---------------------------------------------------------------------------

def _plane_tables(scene, torch, dev):
    """The scene's planes as float64 tables on `dev`, and per plane the
    row of its texture in the component table."""
    f = lambda xs: torch.tensor(np.array(xs), dtype=torch.float64,
                                device=dev)
    tex_ids = sorted({pl.tex_seed for pl in scene})
    row = {s: k for k, s in enumerate(tex_ids)}
    comps, norms = zip(*(texture_components(s) for s in tex_ids))
    big = np.inf
    bounds = [pl.bounds if pl.bounds is not None else (-big, big, -big, big)
              for pl in scene]
    return dict(p0=f([pl.p0 for pl in scene]), n=f([pl.n for pl in scene]),
                eu=f([pl.eu for pl in scene]), ev=f([pl.ev for pl in scene]),
                bounds=f(bounds),
                bounded=torch.tensor([pl.bounds is not None for pl in scene],
                                     device=dev),
                contrast=f([pl.contrast for pl in scene]),
                tex=torch.tensor([row[pl.tex_seed] for pl in scene],
                                 device=dev),
                comps=f(np.stack(comps)), norm=f(norms))


def _in_front(tab, poses, torch):
    """The planes that some frame of `poses` (F, 4, 4) can see: unbounded
    ones, and bounded ones with a corner in front of some camera (a
    camera ray hits only points of positive depth, so a rectangle behind
    every camera of the chunk cannot be hit: leaving it out changes no
    pixel)."""
    b = tab["bounds"].clone()
    b[~tab["bounded"]] = 0.0
    corners = torch.stack([
        tab["p0"] + b[:, i, None] * tab["eu"] + b[:, j, None] * tab["ev"]
        for i in (0, 1) for j in (2, 3)], 1)                     # (M, 4, 3)
    R, t = poses[:, :3, :3], poses[:, :3, 3]
    z = torch.einsum("fk,mck->fmc", R[:, :, 2], corners) - \
        (R[:, :, 2] * t).sum(-1)[:, None, None]                  # (F, M, 4)
    return ~tab["bounded"] | (z > 0).any(-1).any(0)


def _select(tab, keep):
    return {k: (v[keep] if k not in ("comps", "norm") else v)
            for k, v in tab.items()}


def _cast(tab, origins, dirs, t_min, t_max, px_scale, torch, texture=True):
    """Rays of F frames against one scene: origins (F, 3), dirs (F, N, 3).
    Returns (t (F, N), intensity (F, N) or None); the NumPy `_raycast`'s
    arithmetic, every plane at once (the first plane wins a tie, as the
    NumPy loop's strict `<` does)."""
    denom = dirs @ tab["n"].T                                   # (F, N, M)
    num = ((tab["p0"][None] - origins[:, None]) * tab["n"][None]).sum(-1)
    t = num[:, None, :] / denom
    ok = (denom < -1e-9) & (t > t_min) & (t < t_max)
    t_safe = torch.where(ok, t, torch.ones_like(t))
    rel = origins[:, None, :] - tab["p0"][None]                  # (F, M, 3)
    u = (rel * tab["eu"][None]).sum(-1)[:, None, :] + t_safe * (
        dirs @ tab["eu"].T)
    v = (rel * tab["ev"][None]).sum(-1)[:, None, :] + t_safe * (
        dirs @ tab["ev"].T)
    b = tab["bounds"]
    ok &= (u >= b[:, 0]) & (u <= b[:, 1]) & (v >= b[:, 2]) & (v <= b[:, 3])
    dist = torch.linalg.vector_norm(tab["p0"][None] - origins[:, None], dim=-1)
    ok &= ~(tab["bounded"][None] & (dist >= CULL_M))[:, None, :]
    t = torch.where(ok, t, torch.full_like(t, float("inf")))
    best_t, idx = t.min(dim=-1)
    if not texture:
        return best_t, None
    g = idx[..., None]
    u_b = u.gather(-1, g)[..., 0]
    v_b = v.gather(-1, g)[..., 0]
    cosi = denom.gather(-1, g)[..., 0].abs() / torch.clamp(
        torch.linalg.vector_norm(dirs, dim=-1), min=1e-9)
    fp2 = torch.square(best_t * px_scale / torch.clamp(cosi, min=0.05))
    hit = torch.isfinite(best_t)
    fp2 = torch.where(hit, fp2, torch.zeros_like(fp2))
    tex = tab["tex"][idx]
    out = torch.zeros_like(u_b)
    # texture by texture, its waves as the columns of one product: a
    # texture's pixels, each wave's phase and footprint attenuation
    for k in torch.unique(tex[hit]).tolist():
        m = hit & (tex == k)
        amp, r, c, s, ph = tab["comps"][k].unbind(-1)
        phase = u_b[m][:, None] * (r * c) + v_b[m][:, None] * (r * s) + ph
        att = torch.exp(((-0.5 * r) * r)[None, :] * fp2[m][:, None])
        out[m] = (att * torch.sin(phase)) @ amp
    out = out * tab["norm"][tex] * tab["contrast"][idx]
    inten = torch.clamp(127.0 + 110.0 * out, 10.0, 245.0)
    return best_t, torch.where(hit, inten, torch.zeros_like(inten))


def render_lanes(rig, drives, n_frames, device, chunk=16):
    """Frames 0..n_frames-1 of every drive, rendered in float64 on
    `device` in chunks of `chunk` frames: per lane a list of (image (h, w)
    float32, cloud (N, 3) float32) in host memory."""
    import torch

    dev = torch.device(device)
    f64 = dict(dtype=torch.float64, device=dev)
    cam = torch.tensor(rig.camera_dirs(), **f64)
    dl = torch.tensor(rig.lidar_dirs(), **f64)
    T_cl = torch.tensor(rig.T_cam_lidar, **f64)
    # a chunk goes to the host through page-locked buffers (a copy to
    # pageable memory is several times slower), then into each frame's
    # own arrays
    pin = dev.type == "cuda"
    st_img = torch.empty((chunk, rig.h, rig.w), dtype=torch.float32,
                         pin_memory=pin)
    st_pts = torch.empty((chunk * len(dl), 3), dtype=torch.float32,
                         pin_memory=pin)
    out = []
    for drive in drives:
        tab = _plane_tables(drive.scene, torch, dev)
        poses = torch.tensor(drive.poses_wc[:n_frames], **f64)
        frames = []
        for a in range(0, n_frames, chunk):
            T = poses[a:a + chunk]
            seen = _select(tab, _in_front(tab, T, torch))
            _, img = _cast(seen, T[:, :3, 3], cam @ T[:, :3, :3].transpose(
                1, 2), 0.15, 400.0, 1.0 / rig.fx, torch)
            T_wl = T @ T_cl
            t, _ = _cast(tab, T_wl[:, :3, 3], dl @ T_wl[:, :3, :3].transpose(
                1, 2), 1.0, 80.0, 0.0, torch, texture=False)
            m = T.shape[0]
            hit = torch.isfinite(t)
            pts = (dl[None] * t[..., None]).to(torch.float32)[hit]
            ends = hit.sum(-1).cumsum(0).tolist()
            st_img[:m].copy_(img.to(torch.float32).reshape(-1, rig.h, rig.w),
                             non_blocking=pin)
            st_pts[:len(pts)].copy_(pts, non_blocking=pin)
            if pin:
                torch.cuda.current_stream(dev).synchronize()
            imgs, cloud = st_img.numpy(), st_pts.numpy()
            for k in range(m):
                frames.append((imgs[k].copy(),
                               cloud[(ends[k - 1] if k else 0):ends[k]].copy()))
        out.append(frames)
        del tab
    return out
