"""Synthetic stereo sequences with exact ground truth.

The KITTI dataset is not shipped with the repo, so correctness and
benchmarking are driven by synthetic scenes: a camera trajectory through a
field of point landmarks, rendered as Gaussian-blob stereo images with the
same resolution/calibration profile as KITTI seq 00 (1241x376,
fx=718.856, baseline=0.5372 — reference dataset described in SURVEY.md §0).

Two levels of fidelity:
  * geometry-only: exact (uL, uR, v) measurements with known 3D and poses —
    drives unit/golden tests of triangulation/PnP/BA/pose-graph/loops.
  * rendered images: blob splatting at projected landmark positions over a
    low-frequency background — drives the full image pipeline end-to-end
    (detect -> describe -> match -> RANSAC) with known ground-truth poses.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import se3, stereo

KITTI_CALIB = jnp.array(
    [718.856, 718.856, 607.1928, 185.2157, 0.5372], dtype=jnp.float32
)
KITTI_HW = (376, 1241)


@dataclass
class Scene:
    """A synthetic world: landmarks + ground-truth trajectory.

    Each conceptual landmark is rendered as a small 3D *cluster* of points
    (``render_points``): an isolated isotropic dot produces identical
    descriptors for every landmark, so matching would be random; a unique
    satellite constellation per landmark is view-consistent texture that
    descriptors can discriminate.

    ``texture="fractal"`` additionally fills the corridor with a dense 3D
    point field whose intensities follow a multi-octave value-noise
    (fractal/Perlin-class) albedo and whose splat sizes follow a power law
    — approximating natural-image 1/f statistics so scale-space detectors
    (DoG/AKAZE) have real extrema at every octave instead of the
    corner-only structure of the blob scene. The
    photometric model then applies per-frame exposure drift and sensor
    noise (deterministic in the frame index).
    """

    landmarks: jnp.ndarray   # (M, 3) world points (the GT geometry)
    intensities: jnp.ndarray  # (M,) blob brightness
    T_w2c: jnp.ndarray       # (F, 4, 4) ground-truth extrinsics per frame
    calib: jnp.ndarray       # [fx, fy, cx, cy, baseline]
    hw: tuple[int, int]
    render_points: jnp.ndarray | None = None   # (M*S, 3) textured cluster
    render_intens: jnp.ndarray | None = None   # (M*S,)
    texture: str = "blobs"                     # "blobs" | "fractal"
    tex_points: np.ndarray | None = None       # (T, 3) fractal texture field
    tex_intens: np.ndarray | None = None       # (T,) fractal albedo
    tex_sigma: np.ndarray | None = None        # (T,) splat sigma @ 20 m [px]
    photometric: bool = False                  # exposure drift + sensor noise


def straight_trajectory(num_frames: int, step_m: float = 1.0) -> jnp.ndarray:
    """Forward motion along +z with mild lateral sway. Returns T_w2c (F,4,4)."""
    t = jnp.arange(num_frames, dtype=jnp.float32)
    x = 0.5 * jnp.sin(t * 0.05)
    yaw = 0.02 * jnp.sin(t * 0.03)
    z = t * step_m
    R = se3.so3_exp(jnp.stack([jnp.zeros_like(yaw), yaw, jnp.zeros_like(yaw)], -1))
    centers = jnp.stack([x, jnp.zeros_like(x), z], axis=-1)  # camera centers
    # T_w2c = [R^T, -R^T c]
    Rt = jnp.swapaxes(R, -1, -2)
    return se3.make_T(Rt, -jnp.einsum("fij,fj->fi", Rt, centers))


def loop_trajectory(num_frames: int, radius: float = 60.0,
                    turns: float = 1.0) -> jnp.ndarray:
    """Closed circular loop (revisits the start) for loop-closure tests.

    Parametrized so the camera starts at the origin looking along +z and
    drives the circle counter-clockwise (circle center at (radius, 0) in
    the x-z plane); yaw equals the path angle so the camera always faces
    the tangent. ``turns > 1`` keeps driving around — the re-traversal of
    an already-mapped segment (a "familiar path", reference
    loop_closure.py:311-349).
    """
    ang = jnp.linspace(0.0, turns * 2.0 * jnp.pi, num_frames)
    cx = radius * (1.0 - jnp.cos(ang))
    cz = radius * jnp.sin(ang)
    centers = jnp.stack([cx, jnp.zeros_like(cx), cz], axis=-1)
    yaw = ang
    R = se3.so3_exp(jnp.stack([jnp.zeros_like(yaw), yaw, jnp.zeros_like(yaw)], -1))
    Rt = jnp.swapaxes(R, -1, -2)
    return se3.make_T(Rt, -jnp.einsum("fij,fj->fi", Rt, centers))


def clover_trajectory(
    num_frames: int, radii=(100.0, 130.0, 160.0, 145.0)
) -> jnp.ndarray:
    """Seq-00-style multi-revisit topology: consecutive full circles of
    *different* radii, all tangent at the origin with heading +z.

    Each circle covers its own area, but every lap passes back through the
    tangent region — so the sequence has len(radii)-1 distinct revisit
    events separated by long unfamiliar stretches, the loop structure of
    KITTI seq 00 (the reference's committed run log shows 4 closures at
    widely separated frames, final_project/project.py:109-119). Unlike
    ``loop_trajectory(turns>1)``, the revisits are localized: the
    familiar-path state machine sees segment entry/exit per pass instead
    of one sequence-long familiar segment.

    Arc length is distributed uniformly over frames (constant speed
    sum(2*pi*R)/num_frames per frame). Returns T_w2c (F, 4, 4).

    Built entirely in float64 numpy: this is GROUND TRUTH, and on an
    accelerator jnp matmuls (se3.so3_exp / einsum) may default to reduced
    precision (TF32 on the GPU), which at |center| ~ 300 m would corrupt
    the GT by whole meters (ops/precision.py).
    """
    radii_np = np.asarray(radii, np.float64)
    lengths = 2.0 * np.pi * radii_np
    cum = np.concatenate([[0.0], np.cumsum(lengths)])
    s = np.linspace(0.0, cum[-1], num_frames, endpoint=False)
    ci = np.clip(np.searchsorted(cum, s, side="right") - 1, 0,
                 len(radii_np) - 1)
    R = radii_np[ci]
    ang = (s - cum[ci]) / R
    cx = R * (1.0 - np.cos(ang))
    cz = R * np.sin(ang)
    centers = np.stack([cx, np.zeros_like(cx), cz], -1)
    ca, sa = np.cos(ang), np.sin(ang)
    # R_c2w for yaw about +y: [[c,0,s],[0,1,0],[-s,0,c]]; rows of T are R^T
    F = num_frames
    T = np.zeros((F, 4, 4), np.float64)
    T[:, 0, 0] = ca
    T[:, 0, 2] = -sa
    T[:, 1, 1] = 1.0
    T[:, 2, 0] = sa
    T[:, 2, 2] = ca
    T[:, 3, 3] = 1.0
    T[:, :3, 3] = -np.einsum("fij,fj->fi", T[:, :3, :3], centers)
    return jnp.asarray(T, jnp.float32)


# ---------------------------------------------------------------------------
# fractal (natural-image-statistics) texture field
# ---------------------------------------------------------------------------

def _hash3(ix: np.ndarray, iy: np.ndarray, iz: np.ndarray,
           seed: int) -> np.ndarray:
    """Integer-mix hash of 3D lattice coords -> uniform [0, 1) float64."""
    h = (ix.astype(np.int64) * 374761393
         + iy.astype(np.int64) * 668265263
         + iz.astype(np.int64) * 1013904223
         + np.int64(seed) * 974711) & 0x7FFFFFFF
    h = ((h ^ (h >> 13)) * 1274126177) & 0x7FFFFFFF
    h = h ^ (h >> 16)
    return (h & 0xFFFFFF).astype(np.float64) / float(0x1000000)


def _value_noise3(pts: np.ndarray, scale: float, seed: int) -> np.ndarray:
    """Trilinear value noise at world points (smoothstep-blended lattice)."""
    p = pts / scale
    i = np.floor(p).astype(np.int64)
    f = p - i
    u = f * f * (3.0 - 2.0 * f)
    out = np.zeros(len(pts), np.float64)
    for dx in (0, 1):
        wx = u[:, 0] if dx else 1.0 - u[:, 0]
        for dy in (0, 1):
            wy = u[:, 1] if dy else 1.0 - u[:, 1]
            for dz in (0, 1):
                wz = u[:, 2] if dz else 1.0 - u[:, 2]
                c = _hash3(i[:, 0] + dx, i[:, 1] + dy, i[:, 2] + dz, seed)
                out += c * (wx * wy * wz)
    return out


def fractal_albedo(pts: np.ndarray, octaves: int = 5, base_scale: float = 8.0,
                   persistence: float = 0.55, seed: int = 0) -> np.ndarray:
    """Multi-octave fractal value noise in [0, 1] at 3D world points — the
    albedo of the textured scene (Perlin-class 1/f statistics)."""
    amp, tot = 1.0, 0.0
    out = np.zeros(len(pts), np.float64)
    for o in range(octaves):
        out += amp * _value_noise3(pts, base_scale / (2.0 ** o), seed + o)
        tot += amp
        amp *= persistence
    return (out / tot).astype(np.float32)


def make_scene(
    key: jax.Array,
    num_frames: int = 50,
    num_landmarks: int = 4000,
    trajectory: str = "straight",
    hw: tuple[int, int] = (192, 320),
    calib: jnp.ndarray | None = None,
    step_m: float = 1.0,
    corridor_halfwidth: float = 25.0,
    loop_radius: float = 25.0,
    loop_turns: float = 1.0,
    clover_radii=(100.0, 130.0, 160.0, 145.0),
    texture: str = "blobs",
    num_texture_points: int | None = None,
) -> Scene:
    # Scene generation is data preparation, not accelerator work: pin it to
    # the host CPU backend, where the renderer consumes the arrays anyway
    # (on the device every tiny jax.random op would pay a compile and a
    # transfer).
    try:
        cpu = jax.devices("cpu")[0]
    except RuntimeError:
        cpu = None
    if cpu is not None and key.devices() != {cpu}:
        with jax.default_device(cpu):
            return make_scene(
                jax.device_put(key, cpu), num_frames, num_landmarks,
                trajectory, hw, calib, step_m, corridor_halfwidth,
                loop_radius, loop_turns, clover_radii,
                texture, num_texture_points,
            )
    if calib is None:
        # scale KITTI intrinsics to the requested resolution
        sy = hw[0] / KITTI_HW[0]
        sx = hw[1] / KITTI_HW[1]
        calib = jnp.array(
            [
                718.856 * sx,
                718.856 * sy,
                607.1928 * sx,
                185.2157 * sy,
                0.5372,
            ],
            dtype=jnp.float32,
        )
    if trajectory == "straight":
        T_w2c = straight_trajectory(num_frames, step_m)
        length = num_frames * step_m
        k1, k2, k3, k4 = jax.random.split(key, 4)
        lx = jax.random.uniform(k1, (num_landmarks,), minval=-corridor_halfwidth,
                                maxval=corridor_halfwidth)
        ly = jax.random.uniform(k2, (num_landmarks,), minval=-4.0, maxval=4.0)
        lz = jax.random.uniform(k3, (num_landmarks,), minval=-10.0,
                                maxval=length + 60.0)
        landmarks = jnp.stack([lx, ly, lz], axis=-1)
    elif trajectory == "loop":
        T_w2c = loop_trajectory(num_frames, radius=loop_radius,
                                turns=loop_turns)
        k1, k2, k3, k4 = jax.random.split(key, 4)
        # landmarks in an annulus around the circular path
        ang = jax.random.uniform(k1, (num_landmarks,), maxval=2.0 * jnp.pi)
        half = 0.6 * loop_radius
        rad = loop_radius + jax.random.uniform(
            k2, (num_landmarks,), minval=-half, maxval=half
        )
        ly = jax.random.uniform(k3, (num_landmarks,), minval=-4.0, maxval=4.0)
        # annulus around the circle's center at (loop_radius, 0) in x-z
        landmarks = jnp.stack(
            [loop_radius - rad * jnp.cos(ang), ly, rad * jnp.sin(ang)], axis=-1
        )
    elif trajectory == "clover":
        T_w2c = clover_trajectory(num_frames, clover_radii)
        k1, k2, k3, k4 = jax.random.split(key, 4)
        # landmarks in fixed-width corridors around each circle, count
        # proportional to circumference so density is uniform along the path
        radii_np = np.asarray(clover_radii, np.float64)
        frac = radii_np / radii_np.sum()
        counts = np.maximum((frac * num_landmarks).astype(np.int64), 1)
        counts[-1] = num_landmarks - counts[:-1].sum()
        half = corridor_halfwidth
        parts = []
        for i, (R_, n_) in enumerate(zip(radii_np, counts)):
            ka, kb, kc = jax.random.split(jax.random.fold_in(k1, i), 3)
            ang = jax.random.uniform(ka, (int(n_),), maxval=2.0 * jnp.pi)
            rad = R_ + jax.random.uniform(kb, (int(n_),), minval=-half,
                                          maxval=half)
            ly = jax.random.uniform(kc, (int(n_),), minval=-4.0, maxval=4.0)
            parts.append(jnp.stack(
                [R_ - rad * jnp.cos(ang), ly, rad * jnp.sin(ang)], axis=-1
            ))
        landmarks = jnp.concatenate(parts, axis=0)
    else:
        raise ValueError(f"unknown trajectory {trajectory!r}")
    intens = 0.4 + 0.6 * jax.random.uniform(k4, (num_landmarks,))

    # unique satellite constellation per landmark (see Scene docstring):
    # the primary point plus S-1 satellites at random 3D offsets
    S = 4
    ko, ki = jax.random.split(jax.random.fold_in(key, 7))
    offsets = jax.random.uniform(ko, (num_landmarks, S - 1, 3),
                                 minval=-0.2, maxval=0.2)
    sats = landmarks[:, None, :] + offsets
    render_points = jnp.concatenate(
        [landmarks[:, None, :], sats], axis=1
    ).reshape(-1, 3)
    sat_int = intens[:, None] * (
        0.5 + 0.5 * jax.random.uniform(ki, (num_landmarks, S - 1))
    )
    render_intens = jnp.concatenate(
        [intens[:, None], sat_int], axis=1
    ).reshape(-1)

    tex_points = tex_intens = tex_sigma = None
    if texture == "fractal":
        # Dense 3D texture field with natural-image statistics: positions
        # sampled in the SAME corridor volume as the landmarks (so every
        # view is textured), intensities from a multi-octave fractal
        # albedo (signed contrast about the mid-gray background), splat
        # sizes from a power law (p(s) ~ s^-2.5) so scale-space extrema
        # exist at every octave. All texture is world-anchored 3D points:
        # stereo/temporal appearance is geometrically consistent by
        # construction.
        try:
            kd = np.asarray(jax.random.key_data(key))
        except Exception:
            kd = np.asarray(key)
        seed = int(kd.ravel()[-1]) & 0x7FFFFFFF
        rng = np.random.default_rng(seed ^ 0x5EED7E)
        # default density: 40 field points per landmark, capped so
        # reference-scale scenes (100k landmarks) stay renderable in
        # minutes (~45k visible points/frame at the cap)
        nt = (num_texture_points if num_texture_points is not None
              else min(40 * num_landmarks, 1_500_000))
        # Texture lives on SURFACES (ground + two corridor walls), not in
        # a volume: a volumetric splat cloud is semi-transparent, so a
        # descriptor patch mixes splats at different depths whose
        # parallax differs between the eyes — the patch decorrelates and
        # stereo mutual-NN collapses (measured: 28-44/2048 stereo matches
        # at KITTI res with volume texture). Opaque-world surfaces keep
        # patch depth locally coherent, like real imagery.
        def surface(lat, nn, hw_):
            """(lateral, vertical) coords for nn points on ground/walls."""
            s = rng.uniform(0, 1, nn)
            ground = s < 0.5
            wall_r = s >= 0.75
            lat_out = np.where(
                ground, rng.uniform(-hw_, hw_, nn),
                np.where(wall_r, hw_, -hw_) + rng.normal(0, 0.4, nn))
            y = np.where(ground, 1.75 + rng.normal(0, 0.12, nn),
                         rng.uniform(-4.0, 1.8, nn))
            return lat_out, y

        if trajectory == "straight":
            lat, y = surface(None, nt, corridor_halfwidth)
            pts = np.stack([
                lat, y, rng.uniform(-10.0, num_frames * step_m + 60.0, nt)],
                axis=-1)
        elif trajectory == "loop":
            ang = rng.uniform(0, 2 * np.pi, nt)
            lat, y = surface(None, nt, 0.6 * loop_radius)
            rad = loop_radius + lat
            pts = np.stack([
                loop_radius - rad * np.cos(ang), y, rad * np.sin(ang)],
                axis=-1)
        elif trajectory == "clover":
            radii_np2 = np.asarray(clover_radii, np.float64)
            frac2 = radii_np2 / radii_np2.sum()
            cnts = np.maximum((frac2 * nt).astype(np.int64), 1)
            cnts[-1] = nt - cnts[:-1].sum()
            parts2 = []
            for R_, n_ in zip(radii_np2, cnts):
                n_ = int(n_)
                ang = rng.uniform(0, 2 * np.pi, n_)
                lat, y = surface(None, n_, corridor_halfwidth)
                rad = R_ + lat
                parts2.append(np.stack([
                    R_ - rad * np.cos(ang), y, rad * np.sin(ang)], axis=-1))
            pts = np.concatenate(parts2, axis=0)
        else:  # pragma: no cover — trajectory already validated above
            raise ValueError(trajectory)
        # clear tube around the camera path (the 'road': real driving
        # scenes keep the lane free of texture; without it the camera
        # sits inside the splat cloud and near-field blobs at z~1-3 m
        # dominate every frame with huge, fast-moving shapes)
        centers = np.asarray(
            jax.vmap(lambda M: -M[:3, :3].T @ M[:3, 3])(T_w2c))
        sub = centers[:: max(1, len(centers) // 300)][:, [0, 2]]
        pxz = pts[:, [0, 2]]
        d2 = np.full(len(pts), np.inf)
        for c0 in np.array_split(sub, max(1, len(sub) // 64)):
            d2 = np.minimum(
                d2, ((pxz[:, None, :] - c0[None]) ** 2).sum(-1).min(1))
        # horizontal-only clearance (the smooth road strip): vertical is
        # excluded so the textured ground surface 1.75 m below the camera
        # survives everywhere but the lane itself
        keep_t = d2 > 2.0 ** 2
        pts = pts[keep_t]
        nt = len(pts)
        a = fractal_albedo(pts, octaves=5, base_scale=9.0, seed=seed & 0xFFFF)
        tex_points = pts.astype(np.float32)
        # kurtotic amplitudes: natural-image wavelet coefficients are
        # heavy-tailed (sparse strong structure over a weak 1/f bed). A
        # uniform-amplitude dense splat sum is a locally SELF-SIMILAR
        # Gaussian field — descriptors carry no identity and stereo
        # mutual-NN collapses (measured: 28/2048 stereo matches at KITTI
        # res; Pareto amplitudes restore distinctive anchors).
        pareto = (1.0 + rng.pareto(1.2, nt)).clip(max=25.0).astype(
            np.float32)
        pareto /= float(pareto.mean())
        tex_intens = (1.15 * (a - float(a.mean())) * pareto).astype(
            np.float32)
        # inverse-CDF power law on [s_min, s_max], exponent 2.5
        s_min, s_max, alpha = 0.7, 6.0, 2.5
        u = rng.uniform(0, 1, nt)
        one_a = 1.0 - alpha
        tex_sigma = (
            (s_min ** one_a + u * (s_max ** one_a - s_min ** one_a))
            ** (1.0 / one_a)
        ).astype(np.float32)
    elif texture != "blobs":
        raise ValueError(f"unknown texture {texture!r}")

    return Scene(landmarks, intens, T_w2c, calib, hw,
                 render_points=render_points, render_intens=render_intens,
                 texture=texture, tex_points=tex_points,
                 tex_intens=tex_intens, tex_sigma=tex_sigma,
                 photometric=(texture == "fractal"))


# ---------------------------------------------------------------------------
# exact geometry observations (no images)
# ---------------------------------------------------------------------------

def observe_frame(
    scene: Scene, frame: int, noise_px: float = 0.0, key: jax.Array | None = None
):
    """Exact stereo measurements of all visible landmarks in one frame.

    Returns (meas (M,3) = (uL,uR,v), visible (M,) bool, pts_cam (M,3)).
    """
    T = scene.T_w2c[frame]
    pc = se3.transform_points(T, scene.landmarks)
    meas = stereo.project(scene.calib, pc)
    H, W = scene.hw
    vis = (
        (pc[:, 2] > 1.0)
        & (pc[:, 2] < 200.0)
        & (meas[:, 0] >= 0) & (meas[:, 0] < W)
        & (meas[:, 1] >= 0) & (meas[:, 1] < W)
        & (meas[:, 2] >= 0) & (meas[:, 2] < H)
    )
    if noise_px > 0.0 and key is not None:
        meas = meas + noise_px * jax.random.normal(key, meas.shape)
    return meas, vis, pc


# ---------------------------------------------------------------------------
# image rendering (blob splatting)
# ---------------------------------------------------------------------------

def _splat(hw, us, vs, weights, radius: int = 2, sigma: float = 1.0):
    """Render Gaussian blobs at continuous (u, v) via bilinear-free stamped
    scatter-add: a (2r+1)^2 static loop of .at[].add with subpixel-shifted
    Gaussian weights."""
    H, W = hw
    img = jnp.zeros((H, W), jnp.float32)
    ui = jnp.floor(us).astype(jnp.int32)
    vi = jnp.floor(vs).astype(jnp.int32)
    fu = us - ui
    fv = vs - vi
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            w = weights * jnp.exp(
                -((dx - fu) ** 2 + (dy - fv) ** 2) / (2.0 * sigma * sigma)
            )
            x = jnp.clip(ui + dx, 0, W - 1)
            y = jnp.clip(vi + dy, 0, H - 1)
            inb = (ui + dx >= 0) & (ui + dx < W) & (vi + dy >= 0) & (vi + dy < H)
            img = img.at[y, x].add(jnp.where(inb, w, 0.0))
    return img


def render_frame(scene: Scene, frame: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Render the (left, right) grayscale pair for one frame, in [0, 1]."""
    if scene.texture == "fractal":
        # the fractal texture field renders on host (octave-bucketed
        # numpy splatting, render_frame_np); lift the result to jnp
        l, r = render_frame_np(host_scene(scene), int(frame))
        return jnp.asarray(l), jnp.asarray(r)
    if scene.render_points is not None:
        pts = scene.render_points
        intens = scene.render_intens
    else:
        pts = scene.landmarks
        intens = scene.intensities
    T = scene.T_w2c[frame]
    pc = se3.transform_points(T, pts)
    meas = stereo.project(scene.calib, pc)
    H, W = scene.hw
    vis = (
        (pc[:, 2] > 1.0) & (pc[:, 2] < 200.0)
        & (meas[:, 0] >= 0) & (meas[:, 0] < W)
        & (meas[:, 1] >= 0) & (meas[:, 1] < W)
        & (meas[:, 2] >= 0) & (meas[:, 2] < H)
    )
    w = jnp.where(vis, intens, 0.0)
    # modulate brightness by inverse depth so blobs stay distinctive but
    # remain detectable at range
    w = w * jnp.clip(20.0 / jnp.maximum(pc[:, 2], 1.0), 0.5, 2.0)
    left = _splat(scene.hw, meas[:, 0], meas[:, 2], w)
    right = _splat(scene.hw, meas[:, 1], meas[:, 2], w)
    # weak vertical-only background gradient: keeps some image structure
    # without introducing horizontally-periodic texture (a screen-fixed
    # periodic pattern generates self-similar FALSE stereo matches whose
    # spurious disparity passes the rectified gate)
    H, W = scene.hw
    yy = jnp.linspace(0, 4 * jnp.pi, H)[:, None]
    bg = 0.02 * jnp.sin(yy + frame * 0.1) * jnp.ones((1, W))
    left = jnp.clip(left + bg + 0.05, 0.0, 1.0)
    right = jnp.clip(right + bg + 0.05, 0.0, 1.0)
    return left, right


def host_scene(scene: Scene) -> Scene:
    """Scene with every array pulled to host numpy ONCE.

    render_frame_np reads scene fields per frame; if they are device
    arrays, every frame pays a device->host readback. Convert once before
    a render loop.
    """
    cv = lambda x: None if x is None else np.asarray(x)
    return Scene(
        landmarks=cv(scene.landmarks), intensities=cv(scene.intensities),
        T_w2c=cv(scene.T_w2c), calib=cv(scene.calib), hw=scene.hw,
        render_points=cv(scene.render_points),
        render_intens=cv(scene.render_intens),
        texture=scene.texture, tex_points=cv(scene.tex_points),
        tex_intens=cv(scene.tex_intens), tex_sigma=cv(scene.tex_sigma),
        photometric=scene.photometric,
    )


def _splat_np(hw, us, vs, weights, radius: int = 2, sigma=1.0):
    """Host (numpy) twin of _splat: the (2r+1)^2 stamped Gaussian scatter
    as bincount accumulation — ~50x faster than eager per-op dispatch and
    independent of any accelerator, which matters for rendering
    reference-scale (3360-frame) sequences. ``sigma`` may be a scalar or a
    per-point array (the fractal texture field splats variable sizes)."""
    H, W = hw
    us = us.astype(np.float32)
    vs = vs.astype(np.float32)
    ui = np.floor(us).astype(np.int64)
    vi = np.floor(vs).astype(np.int64)
    fu = us - ui
    fv = vs - vi
    img = np.zeros(H * W, np.float64)
    inv2s2 = 1.0 / (2.0 * np.asarray(sigma, np.float32) ** 2)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            w = weights * np.exp(-((dx - fu) ** 2 + (dy - fv) ** 2) * inv2s2)
            x = ui + dx
            y = vi + dy
            inb = (x >= 0) & (x < W) & (y >= 0) & (y < H)
            if not inb.any():
                continue
            img += np.bincount(y[inb] * W + x[inb],
                               weights=w[inb].astype(np.float64),
                               minlength=H * W)
    return img.reshape(H, W).astype(np.float32)


def _upsample_bilinear_np(img: np.ndarray, s: int, out_hw) -> np.ndarray:
    """Bilinear x-s upsample with the cv2 pixel-center convention
    (dst(x) <- src((x+0.5)/s - 0.5)); pure numpy, no cv2 dependency."""
    if s == 1:
        return img[: out_hw[0], : out_hw[1]]
    Hs, Ws = img.shape
    H, W = out_hw
    ys = (np.arange(H, dtype=np.float32) + 0.5) / s - 0.5
    xs = (np.arange(W, dtype=np.float32) + 0.5) / s - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, Hs - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, Ws - 1)
    y1 = np.minimum(y0 + 1, Hs - 1)
    x1 = np.minimum(x0 + 1, Ws - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)[:, None]
    fx = np.clip(xs - x0, 0.0, 1.0)[None, :]
    a = img[np.ix_(y0, x0)]
    b = img[np.ix_(y0, x1)]
    c = img[np.ix_(y1, x0)]
    d = img[np.ix_(y1, x1)]
    return ((a * (1 - fx) + b * fx) * (1 - fy)
            + (c * (1 - fx) + d * fx) * fy).astype(np.float32)


def _splat_np_multiscale(hw, us, vs, weights, sigmas) -> np.ndarray:
    """Variable-size Gaussian splatting via mip octaves: points are
    bucketed by splat sigma; octave o renders sigma in ~[0.75*2^o,
    1.5*2^o) at 1/2^o resolution with an effective sigma in [0.75, 1.5)
    and a small stamp radius, then upsamples bilinearly. O(points * 7^2)
    regardless of blob size (a direct stamp of a sigma-6 blob would cost
    a 31^2 loop). The constant sub-pixel offset of the upsampling is
    shared by both eyes and all frames, so stereo disparity and temporal
    motion of the rendered texture stay geometrically exact."""
    H, W = hw
    sigmas = np.asarray(sigmas, np.float32)
    oct_idx = np.clip(
        np.floor(np.log2(np.maximum(sigmas, 1e-3) / 0.75)).astype(np.int64),
        0, 3)
    img = np.zeros((H, W), np.float32)
    for o in range(4):
        m = oct_idx == o
        if not m.any():
            continue
        s = 1 << o
        Ho, Wo = (H + s - 1) // s, (W + s - 1) // s
        # fine coord u maps to coarse (u + 0.5)/s - 0.5 (pixel centers)
        sub = _splat_np(
            (Ho, Wo),
            (us[m] + 0.5) / s - 0.5,
            (vs[m] + 0.5) / s - 0.5,
            weights[m],
            radius=3,
            sigma=np.clip(sigmas[m] / s, 0.5, 1.6),
        )
        img += _upsample_bilinear_np(sub, s, (H, W))
    return img


def _photometric_np(img: np.ndarray, frame: int, eye: int) -> np.ndarray:
    """Per-frame exposure drift + sensor noise, deterministic in the frame
    index. Gain/bias are shared by the stereo pair (one exposure per rig
    trigger, like KITTI); the Gaussian read noise is per-eye independent."""
    rs = np.random.default_rng(910_001 + 7 * frame)
    gain = (1.0 + 0.10 * np.sin(2 * np.pi * frame / 700.0)
            + 0.03 * rs.standard_normal())
    bias = (0.02 * np.sin(2 * np.pi * frame / 430.0)
            + 0.01 * rs.standard_normal())
    nrng = np.random.default_rng(7717 * (frame + 1) + eye)
    out = gain * img + bias + 0.012 * nrng.standard_normal(
        img.shape).astype(np.float32)
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def _project_np(scene: Scene, pts: np.ndarray, frame: int):
    """(uL, uR, v, z, vis) of world points in the given frame (host math)."""
    T = np.asarray(scene.T_w2c[frame])
    fx, fy, cx, cy, base = np.asarray(scene.calib)
    pc = pts @ T[:3, :3].T + T[:3, 3]
    z = pc[:, 2]
    H, W = scene.hw
    zc = np.where(z > 1e-6, z, 1.0)
    uL = fx * pc[:, 0] / zc + cx
    uR = fx * (pc[:, 0] - base) / zc + cx
    v = fy * pc[:, 1] / zc + cy
    vis = (
        (z > 1.0) & (z < 200.0)
        & (uL >= 0) & (uL < W) & (uR >= 0) & (uR < W) & (v >= 0) & (v < H)
    )
    return uL, uR, v, z, vis


def render_frame_np(scene: Scene, frame: int) -> tuple[np.ndarray, np.ndarray]:
    """Host twin of render_frame (identical scene model, numpy math)."""
    if scene.render_points is not None:
        pts = np.asarray(scene.render_points)
        intens = np.asarray(scene.render_intens)
    else:
        pts = np.asarray(scene.landmarks)
        intens = np.asarray(scene.intensities)
    H, W = scene.hw
    uL, uR, v, z, vis = _project_np(scene, pts, frame)
    w = intens * np.clip(20.0 / np.maximum(z, 1.0), 0.5, 2.0)
    uL, uR, v, w = uL[vis], uR[vis], v[vis], w[vis]

    if scene.texture == "fractal":
        # textured mode: mid-gray base + fractal texture field (signed
        # contrast, variable splat scale, projected splat size ~ 1/z) +
        # the landmark constellations at reduced amplitude
        tuL, tuR, tv, tz, tvis = _project_np(
            scene, np.asarray(scene.tex_points), frame)
        ti = np.asarray(scene.tex_intens)[tvis]
        # apparent size falls off with depth (a world blob of fixed size);
        # reference depth 20 m, clamped so far texture stays sub-pixel
        ts = np.asarray(scene.tex_sigma)[tvis] * np.clip(
            20.0 / np.maximum(tz[tvis], 1.0), 0.12, 2.5)
        tw = ti * np.clip(20.0 / np.maximum(tz[tvis], 1.0), 0.4, 1.6)
        left = _splat_np_multiscale(scene.hw, tuL[tvis], tv[tvis], tw, ts)
        right = _splat_np_multiscale(scene.hw, tuR[tvis], tv[tvis], tw, ts)
        left += _splat_np(scene.hw, uL, v, 0.5 * w)
        right += _splat_np(scene.hw, uR, v, 0.5 * w)
        yy = np.linspace(0, 4 * np.pi, H, dtype=np.float32)[:, None]
        bg = 0.38 + 0.03 * np.sin(yy) * np.ones((1, W), np.float32)
        left = left + bg
        right = right + bg
        # auto-exposure shared by the stereo pair (one AGC per rig
        # trigger, like a real camera): splat weights ACCUMULATE, so the
        # pre-clip dynamic range depends on how much texture the scene
        # geometry packs per pixel — a tight loop saturated ~40% of the
        # frame to white and every detector collapsed (descbench fractal,
        # 69-152/200 pose failures). Percentile mapping bounds clipping
        # to the 5% tails for any texture density.
        p5, p95 = np.percentile(left, [5.0, 95.0])
        gain = 0.8 / max(float(p95 - p5), 0.05)
        bias = 0.45 - gain * 0.5 * float(p5 + p95)
        left = np.clip(gain * left + bias, 0.0, 1.0).astype(np.float32)
        right = np.clip(gain * right + bias, 0.0, 1.0).astype(np.float32)
        if scene.photometric:
            left = _photometric_np(left, frame, eye=0)
            right = _photometric_np(right, frame, eye=1)
        return left, right

    left = _splat_np(scene.hw, uL, v, w)
    right = _splat_np(scene.hw, uR, v, w)
    yy = np.linspace(0, 4 * np.pi, H, dtype=np.float32)[:, None]
    bg = 0.02 * np.sin(yy + frame * 0.1) * np.ones((1, W), np.float32)
    left = np.clip(left + bg + 0.05, 0.0, 1.0).astype(np.float32)
    right = np.clip(right + bg + 0.05, 0.0, 1.0).astype(np.float32)
    return left, right


def render_sequence(
    scene: Scene, chunk: int = 32, on_cpu: bool = True
) -> tuple[np.ndarray, np.ndarray]:
    """Render all frames -> host numpy (F, H, W) float32 pairs.

    Rendering is synthetic-data generation, not a pipeline stage: it runs
    on the host (vectorized numpy splatting) so it never competes with the
    accelerator and scales to reference-length sequences. ``on_cpu`` is
    kept for API compatibility (the host path is always used)."""
    scene = host_scene(scene)
    F = int(scene.T_w2c.shape[0])
    H, W = scene.hw
    L = np.empty((F, H, W), np.float32)
    R = np.empty((F, H, W), np.float32)
    for f in range(F):
        L[f], R[f] = render_frame_np(scene, f)
    return L, R


def ba_windows(key: jax.Array, n_windows: int, P: int = 24, L: int = 512,
               M: int = 4096, calib: jnp.ndarray = KITTI_CALIB):
    """A batch of synthetic bundle-adjustment windows at the production
    shapes (BundleConfig: P poses, L landmarks, M observations), started
    from a perturbed state. Returns (poses0, points0, cam_idx, lm_idx,
    meas, w) with a leading ``n_windows`` axis: the inputs of
    ``ops.ba.optimize_bundle_pruned`` under vmap."""

    def one_window(key):
        k1, k2, k3, k4, k5 = jax.random.split(key, 5)
        t = jnp.arange(P, dtype=jnp.float32)
        xi = jnp.stack([jnp.zeros_like(t), 0.01 * t, jnp.zeros_like(t),
                        0.05 * t, jnp.zeros_like(t), -0.8 * t], axis=-1)
        poses_gt = jax.vmap(se3.se3_exp)(xi)
        u = jax.random.uniform(k1, (L, 3))
        points_gt = jnp.stack([(u[:, 0] - 0.5) * 24.0, (u[:, 1] - 0.5) * 6.0,
                               8.0 + u[:, 2] * 40.0], axis=-1)
        ci = jax.random.randint(k2, (M,), 0, P)
        li = jnp.tile(jnp.arange(L), M // L)[:M]
        T = poses_gt[ci]
        Xc = jnp.einsum("mij,mj->mi", T[:, :3, :3], points_gt[li]) + T[:, :3, 3]
        meas = stereo.project(calib, Xc) + 0.3 * jax.random.normal(k3, (M, 3))
        # observations behind (or grazing) the camera never exist in real
        # data — zero their weights so the LM trajectory is realistic
        w = (Xc[:, 2] > 0.5).astype(jnp.float32)
        dpose = 0.01 * jax.random.normal(k4, (P, 6))
        dpose = dpose.at[0].set(0.0)
        poses0 = jax.vmap(se3.retract)(poses_gt, dpose)
        points0 = points_gt + 0.15 * jax.random.normal(k5, (L, 3))
        return poses0, points0, ci, li, meas, w

    with jax.default_matmul_precision("float32"):
        return jax.vmap(one_window)(jax.random.split(key, n_windows))
