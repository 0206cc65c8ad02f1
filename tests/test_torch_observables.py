"""The port's observables (``bflbm_tpu_torch/observables/``,
``utils/units.py``) against the JAX package's on the same inputs, on the
CPU (``device="cpu"``: numpy inputs are CPU tensors).

Inputs from numpy seeds at 16^3-32^3, in float64: a tanh droplet off
the box centre with noise, a perturbed ellipsoid, a stripe interface,
random walks and velocity series.  Tolerances: fieldwise results within
1e-10 of the reference's scale (its largest magnitude), 1e-9 where an
FFT is involved; scipy-fitted numbers within 1e-6 relative; marching
cubes: faces equal, vertices within 1e-12.  One case a public function.
"""

import numpy as np
import pytest
import torch

from bflbm_tpu.observables import correlation as jcorr
from bflbm_tpu.observables import droplet as jdrop
from bflbm_tpu.observables import droplet_ref_fit as jref
from bflbm_tpu.observables import free_energy as jfe
from bflbm_tpu.observables import interface as jiface
from bflbm_tpu.observables import marching_cubes as jmc
from bflbm_tpu.observables import msd as jmsd
from bflbm_tpu.observables import structfact as jsf
from bflbm_tpu.ops import rfft as jrfft
from bflbm_tpu.utils import units as junits
from bflbm_tpu_torch.observables import correlation as tcorr
from bflbm_tpu_torch.observables import droplet as tdrop
from bflbm_tpu_torch.observables import droplet_ref_fit as tref
from bflbm_tpu_torch.observables import free_energy as tfe
from bflbm_tpu_torch.observables import interface as tiface
from bflbm_tpu_torch.observables import marching_cubes as tmc
from bflbm_tpu_torch.observables import msd as tmsd
from bflbm_tpu_torch.observables import structfact as tsf
from bflbm_tpu_torch.utils import units as tunits

FIELD, FFT, FIT = 1e-10, 1e-9, 1e-6
LO, HI = 0.05, 3.0


def _tanh_droplet(shape, radius, width, com, seed, noise=1e-3):
    r = np.linalg.norm(jdrop.minimum_image(
        jdrop.cell_coords(shape) - np.asarray(com), shape), axis=-1)
    rho = LO + 0.5 * (HI - LO) * (1 + np.tanh((radius - r) / width))
    return rho + noise * np.random.default_rng(seed).normal(size=shape)


def _ellipsoid(shape=(28, 24, 26), axes=(7.5, 6.0, 5.0), seed=2):
    c = jdrop.cell_coords(shape) - np.array([0.7, -0.4, 0.3])
    r = np.sqrt(((c / np.asarray(axes)) ** 2).sum(-1))
    rho = LO + 0.5 * (HI - LO) * (1 + np.tanh((1.0 - r) * 5.0))
    return rho + 1e-3 * np.random.default_rng(seed).normal(size=shape)


def _stripe(shape=(16, 24, 20), seed=3):
    rng = np.random.default_rng(seed)
    y = np.arange(shape[1])
    lo_z = 5.0 + 0.4 * np.sin(2 * np.pi * y / shape[1])
    hi_z = 14.0 + 0.3 * np.cos(4 * np.pi * y / shape[1]) \
        + 0.2 * rng.normal(size=shape[:2])
    z = np.arange(shape[2])[None, None, :]
    rho = LO + 0.5 * (HI - LO) * (np.tanh(z - lo_z[None, :, None])
                                  - np.tanh(z - hi_z[..., None]))
    return rho + 1e-3 * rng.normal(size=shape)


DROP = _tanh_droplet((24, 24, 24), 6.5, 1.1, (1.3, -0.8, 0.4), 1)
PHI = LO + HI - DROP
ELL = _ellipsoid()
COM = jdrop.center_of_mass(DROP - DROP[0, 0, 0])
STRIPE = _stripe()
RNG = np.random.default_rng(7)
WALK = np.cumsum(RNG.normal(0.0, 0.3, size=(60, 3)), axis=0) % 20.0
FRAMES = [{"rho": _tanh_droplet((16, 16, 16), 4.0, 1.0, (0.1 * i, 0, 0),
                                10 + i),
           "phi": np.full((16, 16, 16), 1.0 + 0.01 * i), "step": 10 * i}
          for i in range(4)]


def _close(got, want, tol, path="result"):
    """got within tol of want: arrays and scalars relative to want's
    largest magnitude, integers and strings equal, recursively through
    dicts, tuples and lists."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], tol, f"{path}[{k!r}]")
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, tol, f"{path}[{i}]")
        return
    if isinstance(want, str) or want is None:
        assert got == want, path
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (path, got.shape, want.shape)
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want, err_msg=path)
        return
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                  err_msg=path)
    ok = ~np.isnan(want)
    scale = float(np.abs(want[ok]).max()) if ok.any() else 0.0
    err = float(np.abs(got[ok] - want[ok]).max()) if ok.any() else 0.0
    assert err <= tol * scale, (path, err, scale)


def _units(u):
    sys = u.UnitSystem(dx=2e-9, dt=3e-13, dm=5e-24)
    out = {k: getattr(sys, k) for k in
           ("density_si", "velocity_si", "viscosity_si",
            "surface_tension_si", "diffusion_si", "energy_si")}
    out["stokes"] = sys.stokes_si(0.01)
    out["default_diffusion"] = u.DEFAULT_UNITS.diffusion_si
    out["oh"] = float(u.ohnesorge(0.096, 1.0, 0.0122, 6.2))
    return out


def _heights(m, upper):
    return m.interface_height(STRIPE, 0.5 * (LO + HI), upper=upper)


def _height_series(m):
    """Four stripe frames' filled heights (one column dropped to NaN)."""
    hs = []
    for i in range(4):
        s = _stripe(seed=20 + i)
        s[3, 5, :] = LO               # no crossing: a NaN column
        hs.append(m.fill_missing(m.interface_height(s, 0.5 * (LO + HI))))
    return np.asarray(hs)


def _radius_map(m):
    return m.surface_radius_map(ELL, m.center_of_mass(ELL - LO),
                                0.5 * (LO + HI), 16, 32)


def _mc_field():
    """The perturbed ellipsoid with strong noise: many cube cases,
    ambiguous ones among them."""
    return ELL + 0.25 * np.random.default_rng(9).normal(size=ELL.shape)


def _spectra(m):
    sk = m.spectrum(DROP)
    return np.asarray(sk), m.spectrum(PHI, remove_mean=False)


def _sf_accumulate(m, torch_side):
    """Two frames of the 22-component schema through accumulate /
    finalize (float64)."""
    rng = np.random.default_rng(11)
    frames = [rng.normal(size=(22, 8, 10, 12)) for _ in range(2)]
    if torch_side:
        sf = m.init_structfact(len(m.REFERENCE_PAIRS), (8, 10, 12),
                               dtype=torch.float64, device="cpu")
        for f in frames:
            sf = m.accumulate(sf, torch.as_tensor(f))
    else:
        import jax.numpy as jnp

        sf = m.init_structfact(len(m.REFERENCE_PAIRS), (8, 10, 12),
                               dtype=jnp.float64)
        for f in frames:
            sf = m.accumulate(sf, jnp.asarray(f))
    return m.finalize(sf)


CASES = {
    # utils/units.py
    "units": (_units, FIELD, (junits, tunits)),
    # free_energy.py
    "bulk_free_energy": (lambda m: m.bulk_free_energy(
        np.linspace(0.1, 3.0, 17), 3.1, 1.5), FIELD, (jfe, tfe)),
    "binodal_densities": (lambda m: m.binodal_densities(3.1, 1.5), FIT,
                          (jfe, tfe)),
    "surface_tension_theory": (lambda m: m.surface_tension_theory(3.1, 1.5),
                               FIT, (jfe, tfe)),
    "interface_profile_theory": (lambda m: m.interface_profile_theory(
        3.1, 1.5, 20.0, 401), FIT, (jfe, tfe)),
    "pressure": (lambda m: m.pressure(DROP[:2, :3, :4], PHI[:2, :3, :4],
                                      1.5), FIELD, (jfe, tfe)),
    # structfact.py
    "spectrum": (_spectra, FFT, (jsf, tsf)),
    "fftfreq_grid": (lambda m: (jrfft if m is jsf else m).fftfreq_grid(
        (6, 7, 8)), FIELD, (jsf, tsf)),
    "radial_average": (lambda m: m.radial_average(
        np.asarray(jsf.spectrum(DROP))), FIELD, (jsf, tsf)),
    "radial_average_nbins": (lambda m: m.radial_average(
        np.abs(np.fft.fftn(ELL)) ** 2, nbins=7), FIELD, (jsf, tsf)),
    "structfact_accumulate_finalize": (
        lambda m: _sf_accumulate(m, m is tsf), FFT, (jsf, tsf)),
    "pair_names": (lambda m: list(m.pair_names()), FIELD, (jsf, tsf)),
    # droplet.py
    "cell_coords": (lambda m: m.cell_coords((5, 6, 7)), FIELD,
                    (jdrop, tdrop)),
    "minimum_image": (lambda m: m.minimum_image(
        jdrop.cell_coords((6, 6, 6)) * 1.7, (6, 6, 6)), FIELD,
        (jdrop, tdrop)),
    "center_of_mass": (lambda m: m.center_of_mass(DROP - DROP[0, 0, 0]),
                       FIELD, (jdrop, tdrop)),
    "gyration_tensor": (lambda m: m.gyration_tensor(ELL - LO,
                                                    np.array([0.7, -.4, .3])),
                        FIELD, (jdrop, tdrop)),
    "principal_radii": (lambda m: m.principal_radii(
        ELL - LO, m.center_of_mass(ELL - LO), 6.1), FIELD, (jdrop, tdrop)),
    "radius_from_mass": (lambda m: m.radius_from_mass(DROP), FIELD,
                         (jdrop, tdrop)),
    "radial_profile": (lambda m: m.radial_profile(DROP, COM), FIELD,
                       (jdrop, tdrop)),
    "radial_profile_nbins": (lambda m: m.radial_profile(ELL, COM, 9), FIELD,
                             (jdrop, tdrop)),
    "tanh_profile": (lambda m: m.tanh_profile(np.linspace(0, 12, 25), -0.6,
                                              6.0, LO, HI), FIELD,
                     (jdrop, tdrop)),
    "fit_droplet": (lambda m: m.fit_droplet(DROP), FIT, (jdrop, tdrop)),
    "fit_droplet_allcells": (lambda m: m.fit_droplet_allcells(DROP), FIT,
                             (jdrop, tdrop)),
    "laplace_delta_p": (lambda m: [m.laplace_delta_p(DROP, PHI, 1.5),
                                   m.laplace_delta_p(DROP, PHI, 1.5, COM)],
                        FIELD, (jdrop, tdrop)),
    "shape_fluctuation_gamma": (lambda m: m.shape_fluctuation_gamma(
        6.0 + 0.05 * np.random.default_rng(4).normal(size=(40, 3)), 1e-5),
        FIELD, (jdrop, tdrop)),
    "sphere_grid": (lambda m: m._sphere_grid(8, 12), FIELD, (jdrop, tdrop)),
    "trilinear_periodic": (lambda m: np.asarray(m._trilinear_periodic(
        ELL, np.random.default_rng(5).uniform(-30, 60, size=(7, 9, 3)))),
        FIELD, (jdrop, tdrop)),
    "surface_radius_map": (_radius_map, FIELD, (jdrop, tdrop)),
    "spherical_harmonic_amplitudes": (
        lambda m: m.spherical_harmonic_amplitudes(_radius_map(m), lmax=3),
        FIELD, (jdrop, tdrop)),
    "zeta_equipartition_gamma": (lambda m: m.zeta_equipartition_gamma(
        0.01 * np.random.default_rng(6).normal(size=50), 1e-5), FIELD,
        (jdrop, tdrop)),
    "surface_tension_laplace": (lambda m: m.surface_tension_laplace(
        [5.0, 6.5, 8.0], [0.0051, 0.0039, 0.0031]), FIT, (jdrop, tdrop)),
    # interface.py
    "interface_height_upper": (lambda m: _heights(m, True), FIELD,
                               (jiface, tiface)),
    "interface_height_lower": (lambda m: _heights(m, False), FIELD,
                               (jiface, tiface)),
    "fill_missing": (_height_series, FIELD, (jiface, tiface)),
    "capillary_spectrum": (lambda m: m.capillary_spectrum(
        _height_series(m), axis=1), FFT, (jiface, tiface)),
    "fit_capillary_gamma": (lambda m: m.fit_capillary_gamma(
        *m.capillary_spectrum(_height_series(m)), 1e-5, kmax=2.0), FIT,
        (jiface, tiface)),
    "mean_profile": (lambda m: m.mean_profile(STRIPE), FIELD,
                     (jiface, tiface)),
    "profile_interface_width": (lambda m: m.profile_interface_width(
        m.mean_profile(STRIPE), LO, HI), FIT, (jiface, tiface)),
    "capillary_spectrum_ref": (lambda m: m.capillary_spectrum_ref(
        _height_series(m)[:, 2]), FFT, (jiface, tiface)),
    "fit_capillary_gamma_window": (lambda m: m.fit_capillary_gamma_window(
        *m.capillary_spectrum_ref(_height_series(m)[:, 2]), 1e-5,
        kmin=0.2, kmax=2.0), FIT, (jiface, tiface)),
    # msd.py
    "unwrap_periodic": (lambda m: m.unwrap_periodic(WALK, (20, 20, 20)),
                        FIELD, (jmsd, tmsd)),
    "msd": (lambda m: [m.msd(np.arange(60) * 5.0, m.unwrap_periodic(
        WALK, 20.0), 12), m.msd(np.arange(60), WALK, 5, scalar=False)],
        FIELD, (jmsd, tmsd)),
    "diffusion_coefficient": (lambda m: m.diffusion_coefficient(
        *m.msd(np.arange(60) * 5.0, m.unwrap_periodic(WALK, 20.0), 12)),
        FIT, (jmsd, tmsd)),
    "stokes_einstein": (lambda m: m.stokes_einstein(6.2, 64.0, 0.096, 1e-5,
                                                    0.5), FIELD,
                        (jmsd, tmsd)),
    # correlation.py
    "axis_cut": (lambda m: [m.axis_cut(np.asarray(jsf.spectrum(ELL)), a)
                            for a in range(3)], FIELD, (jcorr, tcorr)),
    "time_series": (lambda m: m.time_series(FRAMES, "rho"), FIELD,
                    (jcorr, tcorr)),
    "time_mean_density": (lambda m: m.time_mean_density(FRAMES), FIELD,
                          (jcorr, tcorr)),
    "velocity_autocorrelation": (lambda m: m.velocity_autocorrelation(
        np.diff(WALK, axis=0), 9), FIELD, (jcorr, tcorr)),
    # marching_cubes.py
    "tri_table": (lambda m: m._tri_table(), FIELD, (jmc, tmc)),
    "boundary_edge_count": (lambda m: m.boundary_edge_count(
        jmc.marching_cubes(_mc_field(), 1.5)[1]), FIELD, (jmc, tmc)),
    "surface_area": (lambda m: m.surface_area(
        *jmc.marching_cubes(ELL, 1.5)), FIELD, (jmc, tmc)),
    "vertex_solid_angle_weights": (lambda m: m.vertex_solid_angle_weights(
        *_centred_mesh()), FIELD, (jmc, tmc)),
    "harmonic_amplitudes": (lambda m: m.harmonic_amplitudes(
        _centred_mesh()[0], jmc.vertex_solid_angle_weights(*_centred_mesh()),
        lmax=3), FIELD, (jmc, tmc)),
    "mc_surface_amplitudes": (lambda m: [
        m.mc_surface_amplitudes(ELL, jdrop.center_of_mass(ELL - LO)),
        m.mc_surface_amplitudes(_mc_field(), np.zeros(3), 1.5, lmax=3)],
        FIELD, (jmc, tmc)),
    # droplet_ref_fit.py
    "field_integrals": (lambda m: _field_integrals(m), FIELD, (jref, tref)),
    "fit_droplet_ref": (lambda m: m.fit_droplet_ref(
        _ref_droplet(), w0=0.0025, r0=0.26, nstep=120), FIT, (jref, tref)),
}


def _centred_mesh():
    verts, faces = jmc.marching_cubes(ELL, 1.5)
    return verts - jdrop.center_of_mass(ELL - LO), faces


def _ref_droplet(n=20, radius=0.27, w=0.002):
    coords = [(np.arange(n) + 0.5) / n for _ in range(3)]
    x, y, z = np.meshgrid(*coords, indexing="ij")
    r = np.sqrt((x - 0.52) ** 2 + (y - 0.47) ** 2 + (z - 0.5) ** 2)
    rho = 0.5 * (1 + np.tanh((radius - r) / np.sqrt(2 * w)))
    return rho + 1e-4 * np.random.default_rng(8).normal(size=rho.shape)


def _field_integrals(m):
    fi = m._FieldIntegrals(_ref_droplet())
    return [fi.r0, fi.mf_wn(0.002, 0.27), fi.mf_rn(0.002, 0.27),
            fi.mf_wn(0.01, 0.2), fi.mf_rn(0.05, 0.31)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_against_jax(name):
    run, tol, (jmod, tmod) = CASES[name]
    _close(run(tmod), run(jmod), tol)


@pytest.mark.parametrize("field", ["droplet", "noisy_ellipsoid", "blob"])
def test_marching_cubes_matches_jax(field):
    """Faces equal (JAX's order: crossings row-major by axis, faces by
    case ascending), vertices within 1e-12."""
    if field == "droplet":
        f, level = DROP, 0.5 * (LO + HI)
    elif field == "noisy_ellipsoid":
        f, level = _mc_field(), 1.5
    else:
        f = np.random.default_rng(12).normal(size=(12, 14, 10))
        level = 0.1
    jv, jf = jmc.marching_cubes(f, level)
    tv, tf = tmc.marching_cubes(f, level)
    assert len(jf) > 100
    np.testing.assert_array_equal(tf, jf)
    assert tv.shape == jv.shape
    assert float(np.abs(tv - jv).max()) <= 1e-12


def test_fields_stay_on_their_device():
    """A tensor's fieldwise work runs on its device (the CPU here): the
    spectrum comes back a float64 tensor there, and a float32 tensor is
    promoted to float64 as numpy promotes the JAX package's inputs."""
    t = torch.as_tensor(DROP, dtype=torch.float32)
    sk = tsf.spectrum(t)
    assert sk.device == t.device and sk.dtype == torch.float64
    _close(tdrop.center_of_mass(t),
           jdrop.center_of_mass(DROP.astype(np.float32).astype(float)),
           FIELD)
