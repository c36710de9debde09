"""S1's per-env body (``deep_q_learning_tpu_torch/csrc/lander_solver.cuh``)
on the CPU: built by g++ (``-O2 -ffp-contract=off``, no fast math) through
``ops/build.py::cached_build`` into a host library that runs every env in
turn, and held against the JAX ``assembly_step`` (vmapped) and the port's
plain version (``envs/lander_solver.py::assembly_step_reference``).

The states and gates are ``tests/test_torch_lander_solver.py``'s: JAX
rollouts with flight, touchdowns, two-point block contacts, joint limits
and crashes, and the settled lander; against JAX the tight tolerances on
99 % of the lanes and every lane within 4x that field's float32
conditioning gap (JAX float32 vs float64, measured here at each iteration
count), the contact, hull-hit and limit flags exact, the sleep flag only
near a threshold.  Against the plain version the same gates, and more:
the host build calls the C library's sinf, cosf and sqrtf where PyTorch's
CPU kernels compute their own (they differ in the last ulp on some inputs,
and on some hosts torch's float32 sqrt is not correctly rounded), so with
the plain version's ``torch.sin``, ``torch.cos`` and ``torch.sqrt``
replaced by the C library's, every lane must be bitwise equal.  That holds
the kernel's body to the plain version operation for operation, the
position loop's early break against its masked loop included.
"""

import ctypes
import subprocess
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deep_q_learning_tpu.envs import lander_solver as J
from deep_q_learning_tpu_torch.envs import lander_solver as T
from deep_q_learning_tpu_torch.ops import build
from deep_q_learning_tpu_torch.ops import solver_kernels as sk
from test_torch_lander_solver import (  # noqa: F401  (fixtures)
    ACC,
    BODY,
    _as_f64,
    _body,
    _check_frame,
    _fields,
    _jax_step,
    _t,
    frame_inputs,
    rollout_states,
)
from test_torch_rigid_kernel import _LibmMath

CXX_FLAGS = ("-x", "c++", "-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
             "-Wno-unknown-pragmas")
ITERS = [(120, 40), (180, 60)]  # the presets', gym's


@pytest.fixture(scope="module")
def host():
    source = build.CSRC_DIR / "lander_solver.cuh"

    def compile_to(out: Path) -> None:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(out), str(source)], check=True,
                       capture_output=True, text=True)

    lib = ctypes.CDLL(str(build.cached_build(source, CXX_FLAGS, build.BUILD_DIR, compile_to)))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.lander_solver_host.argtypes = [ptr, ptr, i32, i32, i32, i32]
    lib.lander_collide_host.argtypes = [ptr] * 5 + [i32, ptr, ptr]
    lib.lander_math_host.argtypes = [ptr, ptr, i32, i32]
    lib.lander_quot_host.argtypes = [ptr, ptr, i32, ptr, ptr]
    lib.lander_sincos_poly_host.argtypes = [ptr, i32, ptr, ptr]
    lib.lander_trig_fast_host.argtypes = [ptr, i32, ptr, ptr, ptr]
    lib.lander_solver_sizes.argtypes = [ptr]
    sk.check_sizes(lib)
    return lib


def _launch(lib, others=False):
    def launch(io, consts, n, vel, pos):
        lib.lander_solver_host(ctypes.byref(io), ctypes.byref(consts), n, vel, pos, int(others))
    return launch


def _inputs(inputs):
    hull, l1, l2, terrain, (fx, fy, tq), acc = inputs
    return (_body(hull), _body(l1), _body(l2), _t(terrain), _t(fx), _t(fy), _t(tq), -10.0,
            T.AssemblyAcc(*(_t(getattr(acc, f)) for f in ACC)))


def _host_step(lib, inputs, vel, pos, vel_tol=0.0, return_iters=False, return_pos_iters=False,
               others=False):
    """The host build on ``inputs``; with ``others``, every group runs all
    the passes its loops allow, its values kept from where it was done, as
    a group of the kernel does in a warp whose other groups run on."""
    *args, acc = _inputs(inputs)
    return sk.assembly_step_call(_launch(lib, others), *args, acc, 1.0 / T.FPS, vel, pos,
                                 vel_tol, return_iters, return_pos_iters)


def _plain_step(inputs, vel, pos, **kw):
    *args, acc = _inputs(inputs)
    return T.assembly_step_reference(*args, acc=acc, vel_iters=vel, pos_iters=pos, **kw)


def _lanes_equal(a, b, n):
    """Per lane: every body field, accumulator and flag of two results equal."""
    same = torch.ones(n, dtype=torch.bool)
    for x, y in zip(a[:3], b[:3]):
        for f in BODY:
            same &= getattr(x, f) == getattr(y, f)
    for f in ACC:
        same &= (getattr(a[7], f) == getattr(b[7], f)).reshape(n, -1).all(1)
    for i in range(3, 7):
        same &= a[i] == b[i]
    return same


@pytest.fixture(scope="module")
def conditioning_at(frame_inputs):  # noqa: F811
    """Per iteration count and field, the largest gap over the lanes between
    JAX's float32 frame and the same JAX code in float64."""
    cache = {}

    def get(vel, pos):
        if (vel, pos) not in cache:
            ref = _jax_step(frame_inputs, vel_iters=vel, pos_iters=pos)
            with jax.enable_x64(True):
                wide = jax.tree.map(
                    lambda x: x.astype(np.float64) if x.dtype == np.float32 else x, frame_inputs)
                ref64 = _jax_step(wide, vel_iters=vel, pos_iters=pos)
            n = len(ref[3])
            cache[vel, pos] = ref, {
                name: float(np.abs(_as_f64(a, n) - _as_f64(b, n)).max())
                for (name, _, a), (_, _, b) in zip(_fields(ref), _fields(ref64))
            }
        return cache[vel, pos]

    return get


# ----------------------------------------------------------------- one frame
@pytest.mark.parametrize("vel,pos", ITERS)
def test_host_body_matches_jax_and_plain(host, frame_inputs, conditioning_at, vel, pos):  # noqa: F811
    ref, conditioning = conditioning_at(vel, pos)
    got = _host_step(host, frame_inputs, vel, pos)
    gaps, misses = _check_frame(got, ref, conditioning)
    plain = _plain_step(frame_inputs, vel, pos)
    _check_frame(got, _as_reference(plain), conditioning)
    n = len(ref[3])
    share = float(_lanes_equal(got, plain, n).float().mean())
    print(f"({vel}, {pos}): float32 conditioning {conditioning}; vs JAX largest gaps {gaps}, {misses} of {n} lanes past the tight "
          f"tolerances; bitwise the plain version (PyTorch's own sin, cos and sqrt) on {100 * share:.1f} % "
          f"of the lanes")


def _as_reference(out):
    """A plain-version result in the form ``_check_frame`` takes for its
    reference (JAX's): every tensor as a numpy array."""
    def np_(x):
        if isinstance(x, torch.Tensor):
            return x.numpy()
        return type(x)(*(getattr(x, f).numpy() for f in (BODY if isinstance(x, T.Body) else ACC)))
    return [np_(x) for x in out]


def _lanes(inputs, n):
    """``n`` of the rollout lanes, drawn with a fixed seed (flight, contacts
    and limits mixed), as ``frame_inputs`` holds them."""
    hull, l1, l2, terrain, forces, acc = inputs
    pick = np.sort(np.random.default_rng(n).choice(len(terrain), n, replace=False))
    take = lambda tree: jax.tree.map(lambda x: np.asarray(x)[pick], tree)  # noqa: E731
    return take(hull), take(l1), take(l2), take(terrain), take(forces), take(acc)


# every lane, and ragged counts of envs: one group, a part-full warp, a
# warp and a group past a block of the kernel's launch
BITWISE_CASES = [pytest.param(vel, pos, None, id=f"{vel}-{pos}") for vel, pos in ITERS] + [
    pytest.param(*ITERS[0], n, id=f"{ITERS[0][0]}-{ITERS[0][1]}-n{n}") for n in (1, 3, 33)]


@pytest.mark.parametrize("vel,pos,n", BITWISE_CASES)
def test_host_body_is_the_plain_version_bitwise(host, frame_inputs, vel, pos, n):  # noqa: F811
    """With the same sinf, cosf and sqrtf, the host build and the plain
    version agree bit for bit on every lane: every other operation rounds
    the same.  The
    host build runs the kernel's lane groups (every lane of a group in
    turn, its shuffles reads of the other lanes' values) over the launch's
    envs, so this holds the group decomposition itself to the plain
    version, on all rollout lanes and at ragged counts; and again with
    every group running the passes a warp's other groups would make it run
    (the dropped passes and the selects of the kernel's converged warp)."""
    inputs = frame_inputs if n is None else _lanes(frame_inputs, n)
    with _LibmMath(host):
        plain = _plain_step(inputs, vel, pos)
    for others in (False, True):
        got = _host_step(host, inputs, vel, pos, others=others)
        same = _lanes_equal(got, plain, len(got[3]))
        assert bool(same.all()), (others, int((~same).sum()), torch.nonzero(~same).flatten()[:10])


def test_sin_cos_reused_only_for_the_same_angle_bits(host):
    """No sin/cos is reused across a pass's angles any more: the position
    pass takes ``lander_solver.cuh::trig_fast`` of every angle anew, so
    equal floats of other bits (+0.0 and -0.0, whose sines differ in sign),
    neighbours, NaNs of other payloads and repeated angles each get the C
    library's sinf/cosf in the host build, bit for bit; the angles at or
    past 105615, infinite or NaN are flagged for sincosf itself."""
    f32 = np.float32
    nan_a = np.array([0x7FC00001], np.uint32).view(np.float32)[0]
    nan_b = np.array([0x7FC00002], np.uint32).view(np.float32)[0]
    up = np.nextafter(f32(0.3), f32(1.0))
    edge = np.nextafter(f32(105615.0), f32(0.0))
    angles = [f32(0.3), f32(0.3), up, f32(-0.3), f32(0.0), f32(-0.0), f32(-1e5), f32(2.0),
              edge, -edge, f32(105615.0), f32(-105615.0), f32(1e6), f32(np.inf), nan_a, nan_b]
    a = torch.tensor(angles)
    c, s = torch.empty_like(a), torch.empty_like(a)
    fast = torch.empty(a.shape, dtype=torch.uint8)
    host.lander_trig_fast_host(a.data_ptr(), len(angles), c.data_ptr(), s.data_ptr(),
                               fast.data_ptr())
    want_s, want_c = torch.empty_like(a), torch.empty_like(a)
    host.lander_math_host(a.data_ptr(), want_s.data_ptr(), len(angles), 0)
    host.lander_math_host(a.data_ptr(), want_c.data_ptr(), len(angles), 1)
    bits = lambda t: t.view(torch.int32)  # noqa: E731
    assert torch.equal(bits(s), bits(want_s)) and torch.equal(bits(c), bits(want_c))
    assert fast.bool().tolist() == [True] * 10 + [False] * 6
    assert bits(s)[4] != bits(s)[5], "sin(+0.0) and sin(-0.0) differ in sign"


# ------------------------------------------------ the velocity pass's division
def _quot(lib, a, b):
    a, b = np.ascontiguousarray(a, np.float32), np.ascontiguousarray(b, np.float32)
    out, fast = np.empty_like(a), np.empty(a.shape, np.uint8)
    lib.lander_quot_host(a.ctypes.data, b.ctypes.data, a.size, out.ctypes.data, fast.ctypes.data)
    return out, fast.astype(bool)


def _edge_floats():
    """Zeros, subnormals, the range's ends and their neighbours, huge and
    infinite values and a NaN, each with both signs."""
    f32 = np.float32
    tiny = np.array([1, 0x7FFFFF], np.uint32).view(np.float32)  # the least and largest subnormal
    ends = [f32(2.0**-86), f32(2.0**86), f32(2.0**-40), f32(2.0**40)]
    near = [np.nextafter(x, f32(d)) for x in ends for d in (0.0, np.inf)]
    mags = [f32(0.0), *tiny, np.finfo(np.float32).tiny, f32(1.0), f32(3.0), *ends, *near,
            np.finfo(np.float32).max, f32(np.inf), f32(np.nan)]
    return np.array([s * m for m in mags for s in (1.0, -1.0)], np.float32)


def test_quotient_is_the_division_bit_for_bit(host):
    """``lander_fast_math.cuh::quot`` (a velocity pass's division by a frame's
    divisor: Markstein's two corrections from the correctly rounded
    reciprocal, plain division outside its range) against IEEE float32
    division, bit for bit, NaNs included: over 2^22 random pairs with
    exponents from 2^-60 to 2^60 and both signs, over every pair of the edge
    operands, and over quotients whose operands share a mantissa or sit a
    binade apart (exact and near-tie quotients).  The short form is taken
    exactly where both operands are in its range."""
    rng = np.random.default_rng(22)
    n = 1 << 22
    bits = lambda e: ((rng.integers(0, 2, n, dtype=np.uint32) << 31)  # noqa: E731
                      | ((e + 127).astype(np.uint32) << 23)
                      | rng.integers(0, 1 << 23, n, dtype=np.uint32)).view(np.float32)
    a, b = bits(rng.integers(-60, 61, n)), bits(rng.integers(-60, 61, n))
    edge = _edge_floats()
    ea, eb = (x.ravel() for x in np.meshgrid(edge, edge))
    m = (rng.integers(0, 1 << 23, 4096, dtype=np.uint32) | (127 << 23)).view(np.float32)
    sa = np.concatenate([m, m * np.float32(2.0), np.nextafter(m, np.float32(2.0))])
    sb = np.concatenate([m, m, m])
    for x, y in ((a, b), (ea, eb), (sa, sb)):
        got, fast = _quot(host, x, y)
        with np.errstate(all="ignore"):
            want = x / y
        assert want.dtype == np.float32
        differ = got.view(np.uint32) != want.view(np.uint32)
        assert not differ.any(), (x[differ][:5], y[differ][:5], got[differ][:5], want[differ][:5])
        ma, mb = np.abs(x), np.abs(y)
        in_range = (((ma >= 2.0**-86) & (ma <= 2.0**86)) | (ma == 0)) & (mb >= 2.0**-40) & (mb <= 2.0**40)
        assert np.array_equal(fast, in_range)
    assert fast.all() and _quot(host, a, b)[1].mean() > 0.3


def test_slop_threshold_is_the_square_root_test(host):
    """The position pass tests ``e <= linear_slop_sq`` where the plain
    version tests ``sqrt(e) <= LINEAR_SLOP``: over every float32 within 2^16
    ulps of the threshold, and zero, the slop's own square, huge, infinite
    and NaN errors, the two tests agree with the C library's sqrtf; the
    threshold is the kernel's constant, and its next float fails."""
    f32 = np.float32
    t = f32(sk.sqrt_threshold(T.LINEAR_SLOP))
    assert sk.solver_consts(1.0 / T.FPS, -10.0, 0.0).linear_slop_sq == t
    near = (t.view(np.int32) + np.arange(-(1 << 16), (1 << 16) + 1, dtype=np.int32)).view(np.float32)
    far = np.array([0.0, f32(T.LINEAR_SLOP) ** 2, 1e-30, 1.0, 3e38, np.inf, np.nan], np.float32)
    x = np.concatenate([near, far])
    root = torch.empty(x.shape[0], dtype=torch.float32)
    host.lander_math_host(torch.from_numpy(x).data_ptr(), root.data_ptr(), x.shape[0], 3)
    assert np.array_equal(root.numpy() <= f32(T.LINEAR_SLOP), x <= t)
    after = np.nextafter(t, f32(np.inf))
    assert np.sqrt(t) <= f32(T.LINEAR_SLOP) < np.sqrt(after)


def test_sincos_poly_is_sine_and_cosine(host):
    """``lander_fast_math.cuh::sincos_poly`` (the card's ``sincosf`` below
    105615, written out without its branch; chip_smoke.py holds it to
    ``sincosf`` on every such float) built for the host: within 2 ulps of
    the C library's sinf and cosf over 2^20 angles across the range, the
    quadrants' boundaries and tiny angles, and exact at zero (its sign kept
    in the sine)."""
    rng = np.random.default_rng(5)
    quarter = (np.arange(-400, 401) * (np.pi / 4)).astype(np.float32)
    a = np.concatenate([
        rng.uniform(-105614.0, 105614.0, 1 << 19).astype(np.float32),
        rng.uniform(-8.0, 8.0, 1 << 19).astype(np.float32),
        quarter, np.nextafter(quarter, np.float32(np.inf)), np.nextafter(quarter, np.float32(-np.inf)),
        np.array([0.0, -0.0, 1e-30, -1e-30, 1e-6, -1e-6], np.float32)])
    s, c = np.empty_like(a), np.empty_like(a)
    host.lander_sincos_poly_host(a.ctypes.data, a.size, s.ctypes.data, c.ctypes.data)
    want_s, want_c = torch.empty(a.size), torch.empty(a.size)
    host.lander_math_host(torch.from_numpy(a).data_ptr(), want_s.data_ptr(), a.size, 0)
    host.lander_math_host(torch.from_numpy(a).data_ptr(), want_c.data_ptr(), a.size, 1)
    for got, want in ((s, want_s.numpy()), (c, want_c.numpy())):
        ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
        assert int(ulps.max()) <= 2, (a[np.argmax(ulps)], got[np.argmax(ulps)], want[np.argmax(ulps)])
    zero = s[-6:-4].view(np.uint32)
    assert zero[0] == 0 and zero[1] == 0x80000000 and (c[-6:-4] == 1.0).all()


def test_vel_tol_branch_matches_jax_and_plain(host, frame_inputs, conditioning_at):  # noqa: F811
    """The early-exit branch: each lane stops once its accumulators change
    by less than vel_tol in a pass and keeps its state.  ``used`` equals the
    plain version's exactly, and JAX's where test_torch_lander_solver.py
    allows; every lane bitwise the plain version with the same sin, cos and
    sqrt."""
    vel, pos = ITERS[0]
    kw = dict(vel_iters=vel, pos_iters=pos, vel_tol=1e-4, return_iters=True)
    ref = _jax_step(frame_inputs, **kw)
    got = _host_step(host, frame_inputs, vel, pos, vel_tol=1e-4, return_iters=True)
    _check_frame(got[:8], ref[:8], conditioning_at(vel, pos)[1])
    used = got[8]
    assert used.dtype == torch.int32 and (used >= 1).all() and (used <= vel).all()
    assert (ref[8] < vel).mean() > 0.5, "most lanes must exit early"
    assert (used.numpy() != ref[8]).mean() <= 0.01
    plain = _plain_step(frame_inputs, vel, pos, vel_tol=1e-4, return_iters=True)
    assert torch.equal(used, plain[8])
    with _LibmMath(host):
        plain = _plain_step(frame_inputs, vel, pos, vel_tol=1e-4, return_iters=True)
    assert bool(_lanes_equal(got, plain, len(used)).all()) and torch.equal(used, plain[8])
    got = _host_step(host, frame_inputs, vel, pos, vel_tol=1e-4, return_iters=True, others=True)
    assert bool(_lanes_equal(got, plain, len(used)).all()) and torch.equal(got[8], plain[8])


def test_position_loop_break_equals_the_masked_loop(host, frame_inputs):  # noqa: F811
    """The body leaves the position loop after the first pass that meets
    Box2D's slop test, where the plain version runs every pass with the
    lane masked: with the same sin, cos and sqrt, the two agree bit for bit
    at 40 and at 60 passes, and a lane that stopped after k passes has at 40
    passes the values of a run cut to k."""
    vel = ITERS[0][0]
    out = {}
    for pos in (40, 60):
        got = _host_step(host, frame_inputs, vel, pos, return_pos_iters=True)
        with _LibmMath(host):
            plain = _plain_step(frame_inputs, vel, pos)
        assert bool(_lanes_equal(got[:8], plain, len(got[3])).all()), pos
        out[pos] = got
    ran = out[40][8]
    assert (ran < 40).float().mean() > 0.9 and (ran == 40).any() and (ran >= 1).all()
    assert torch.equal(torch.where(ran < 40, out[60][8], ran), ran)
    for k in sorted(set(ran.tolist()))[:6]:
        cut = _host_step(host, frame_inputs, vel, k)
        lanes = ran == k
        assert bool(_lanes_equal(cut, out[40], len(ran))[lanes].all()), k


# ---------------------------------------------------------------- geometry
def _collide(lib, terrain, leg):
    n = terrain.shape[0]
    idx = torch.empty((n, 2), dtype=torch.int32)
    flags = torch.empty((n, 3), dtype=torch.bool)
    k = sk.solver_consts(1.0 / T.FPS, -10.0, 0.0)
    lib.lander_collide_host(terrain.data_ptr(), leg.cx.data_ptr(), leg.cy.data_ptr(),
                            leg.a.data_ptr(), ctypes.byref(k), n, idx.data_ptr(), flags.data_ptr())
    return idx, flags


def test_deepest_corner_ties_pick_the_first(host):
    """A level leg on flat terrain has its two bottom corners (0, 1) at one
    depth: the body's manifold takes corner 0 then corner 1, as argmin's
    first of equal minima does in JAX and in the plain version."""
    n = 64
    rng = np.random.default_rng(3)
    terrain = np.full((n, J.CHUNKS), 0.99 * 13.333 / 4.0, np.float32)
    z = np.zeros(n, np.float32)
    leg = J.Body(rng.uniform(1, 19, n).astype(np.float32),
                 (terrain[:, 0] + rng.uniform(-0.2, 0.4, n)).astype(np.float32), z, z, z, z)
    want, _ = jax.tree.map(np.asarray, jax.jit(jax.vmap(J.collide_leg))(terrain, leg))
    idx, flags = _collide(host, _t(terrain), _body(leg))
    assert (want.idx1 == 0).all() and (want.idx2 == 1).all()
    np.testing.assert_array_equal(idx[:, 0].numpy(), want.idx1)
    np.testing.assert_array_equal(idx[:, 1].numpy(), want.idx2)
    np.testing.assert_array_equal(flags[:, 0].numpy(), want.active1)
    assert want.active1.any() and not want.active1.all()


def test_manifolds_match_the_plain_version(host, frame_inputs):  # noqa: F811
    """Corner indices and flags of every leg of the rollout states, the
    tilted and penetrating ones included, equal the plain version's."""
    _, l1, l2, terrain, _, _ = frame_inputs
    for leg in (l1, l2):
        c, _ = T.collide_leg(_t(terrain), _body(leg))
        idx, flags = _collide(host, _t(terrain), _body(leg))
        assert torch.equal(idx[:, 0].long(), c.idx1) and torch.equal(idx[:, 1].long(), c.idx2)
        for i, f in enumerate(("active1", "active2", "block")):
            assert torch.equal(flags[:, i], getattr(c, f)), f


# ---------------------------------------------------------- the dispatcher
def test_assembly_step_on_cpu_tensors_is_the_plain_version(frame_inputs):  # noqa: F811
    *args, acc = _inputs(frame_inputs)
    sk.reset_counts()
    got = T.assembly_step(*args, acc=acc, vel_iters=60, pos_iters=20)
    want = T.assembly_step_reference(*args, acc=acc, vel_iters=60, pos_iters=20)
    assert bool(_lanes_equal(got, want, len(got[3])).all())
    assert sk.launches == {"assembly_step": 0} and sk.plain_calls == {"assembly_step": 1}


def test_wrapper_checks_its_inputs():
    """The kernel's wrapper refuses a wrong dtype, a non-contiguous input
    and a wrong shape, and CPU tensors (``assembly_step`` takes the plain
    version for those); so does the measurements' entry; nothing launches."""
    n = 4
    z = torch.zeros(n)
    body = T.Body(z, z, z, z, z, z)
    terrain = torch.zeros((n, T.CHUNKS))
    args = [body, body, body, terrain, z, z, z, -10.0]
    sk.reset_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        sk.assembly_step_kernel(*args, vel_iters=2, pos_iters=1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sk.position_passes(*args, T.zero_acc(n, z.device), vel_iters=2, pos_iters=1)
    with pytest.raises(TypeError, match="dtype"):
        sk.assembly_step_kernel(*args[:4], z.double(), *args[5:])
    with pytest.raises(ValueError, match="contiguous"):
        sk.assembly_step_kernel(*args[:3], torch.zeros((T.CHUNKS, n)).t(), *args[4:])
    with pytest.raises(ValueError, match="shape"):
        sk.assembly_step_kernel(*args[:4], torch.zeros(n + 1), *args[5:])
    assert sk.launches == {"assembly_step": 0} and sk.plain_calls == {"assembly_step": 0}


# ------------------------------------------------------------------- work
_ARITH = {"add", "sub", "rsub", "mul", "div", "neg", "sqrt", "sin", "cos", "abs", "floor",
          "clamp", "clamp_min", "clamp_max", "minimum", "maximum", "reciprocal"}


def _is_one(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.dim() == 0 and float(x) == 1.0
    return x == 1.0


class _CountArithmetic(TorchDispatchMode):
    """Float arithmetic of the plain version, one operation an element: an
    elementwise op counts its output's elements, a max reduction its input's
    less its output's; ``x * 1.0`` (how PyTorch writes ``1.0 / t``, after a
    reciprocal) counts nothing."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if isinstance(out, torch.Tensor) and out.is_floating_point():
            if name == "amax":
                self.ops += args[0].numel() - out.numel()
            elif name in _ARITH and not (name == "mul" and _is_one(args[1])):
                self.ops += out.numel()
        return out


@pytest.mark.parametrize("n,vel,pos", [(5, 3, 2), (37, 2, 4)])
def test_work_counts_what_the_code_does(frame_inputs, n, vel, pos):  # noqa: F811
    """``assembly_step_work``: the bytes of a call's inputs and outputs, and
    the plain version's arithmetic (which the kernel's body repeats, branch
    for branch), at two shapes and on the vel_tol branch."""
    sub = [x for x in _inputs(frame_inputs)]
    pick = lambda t: t[:n].contiguous() if isinstance(t, torch.Tensor) else t  # noqa: E731
    args = [T.Body(*(pick(getattr(b, f)) for f in BODY)) for b in sub[:3]]
    args += [pick(x) for x in sub[3:8]]
    acc = T.AssemblyAcc(*(pick(getattr(sub[8], f)) for f in ACC))
    count = _CountArithmetic()
    with count:
        out = T.assembly_step_reference(*args, acc=acc, vel_iters=vel, pos_iters=pos)
    nbytes, ops = sk.assembly_step_work(n, vel, pos)
    assert ops == count.ops

    def size(tree):
        leaves = [tree] if isinstance(tree, torch.Tensor) else [
            getattr(tree, f) for f in (BODY if isinstance(tree, T.Body) else ACC)]
        return sum(t.numel() * t.element_size() for t in leaves)

    given = sum(size(x) for x in args if not isinstance(x, float)) + size(acc)
    assert nbytes == given + sum(size(x) for x in out)
    count = _CountArithmetic()
    with count:
        out = T.assembly_step_reference(*args, acc=acc, vel_iters=vel, pos_iters=pos,
                                        vel_tol=1e-9, return_iters=True)
    # the plain version runs every lane until the last one stops
    ran = int(out[8].max())
    assert sk.assembly_step_work(n, ran, pos, vel_tol=1e-9, return_iters=True) == (
        nbytes + 4 * n, count.ops)


def _free_flight(n):
    """``n`` landers high above flat terrain, each joint mid-way between its
    limits and every angle distinct: no contact, no limit, no clamp."""
    rng = np.random.default_rng(5)
    f = lambda lo, hi: torch.tensor(rng.uniform(lo, hi, n), dtype=torch.float32)  # noqa: E731
    ha = f(-0.2, 0.2)
    hull = T.Body(f(6, 14), f(11, 12), ha, f(-0.5, 0.5), f(-0.5, 0.5), f(-0.1, 0.1))
    legs = [T.Body(hull.cx + dx, hull.cy - 0.5, ha + da + f(-0.05, 0.05), f(-0.5, 0.5),
                   f(-0.5, 0.5), f(-0.1, 0.1)) for dx, da in ((-0.6, 0.55), (0.6, -0.55))]
    terrain = torch.full((n, T.CHUNKS), 3.3)
    z = torch.zeros(n)
    return [hull, *legs, terrain, z, z, z, -10.0, T.zero_acc(n)]


def test_needed_work_in_free_flight():
    """``needed_work`` where every select's choice is known: in free flight
    a velocity pass keeps the point rows of both joints and the sequential
    case of both legs (430 - 2 * 32 - 2 * 24 operations an env), the first
    pass also drops each joint's limit terms (2 * 48), and the frame keeps
    sin and cos of three angles of 14 calls, no clamp (3 bodies * 3
    operations) and the block determinant only where the block is kept."""
    n = 6
    *args, acc = _free_flight(n)
    c, _ = T.collide_leg(torch.cat([args[3], args[3]]), T._cat_bodies(args[1], args[2]))
    d = T._contact_data(T._cat_bodies(args[1], args[2]), c)
    assert not bool(c.active1.any() | c.active2.any())
    for leg, side in ((args[1], -1.0), (args[2], 1.0)):
        assert not bool(T._joint_data(args[0].a, leg.a, side)["limit_active"].any())
    ill = int((d["det"] == 1.0).sum())
    passes = torch.zeros(n, dtype=torch.int32)
    work = [sk.needed_work(*args, acc, passes, vel_iters=v, pos_iters=0) for v in (0, 1, 2)]
    assert work[0] == (sk.assembly_step_work(n, 0, 0)[0],
                       n * (sk.FRAME_OPS - (14 - 6) - 9) - sk.BLOCK_DET * ill)
    assert work[1][1] - work[0][1] == n * (sk.VEL_PASS_OPS - 2 * 32 - 2 * 24 - 2 * 48)
    assert work[2][1] - work[1][1] == n * (sk.VEL_PASS_OPS - 2 * 32 - 2 * 24)


@pytest.mark.parametrize("n,vel,pos", [(5, 3, 2), (37, 2, 4)])
def test_needed_work_leaves_out_what_selects_drop(host, frame_inputs, n, vel, pos):  # noqa: F811
    """On rollout states (contacts, limits and crashes): ``needed_work``
    has ``assembly_step_work``'s bytes and passes, and of its operations
    leaves out no more than every branch and sin/cos call it may drop; the
    same with vel_tol > 0, whose passes are the plain version's."""
    inputs = _lanes(frame_inputs, n)
    *args, acc = _inputs(inputs)
    ran = _host_step(host, inputs, vel, pos, return_pos_iters=True)[-1]
    for tol in (0.0, 1e-9):
        nbytes, ops = sk.needed_work(*args, acc, ran, vel_iters=vel, pos_iters=pos, vel_tol=tol)
        used = T.assembly_step_reference(*args, acc=acc, vel_iters=vel, pos_iters=pos,
                                         vel_tol=tol, return_iters=True)[8]
        plain = sk.assembly_step_work(n, used, ran, tol)
        assert nbytes == plain[0]
        vel_drop = 2 * sk.JOINT_DROPS["inactive"] + 2 * sk.BLOCK_OPS
        most = (n * (14 - 2 + 2 * sk.JOINT_FRAME_DROP + 9 + 2 * sk.BLOCK_DET)
                + int(used.sum()) * vel_drop
                + int(ran.sum()) * (16 - 2 + 4 * sk.POS_CORNER_DROP + 2 * sk.POS_LIMIT_OPS))
        assert plain[1] - most <= ops < plain[1], (ops, plain[1], most)
