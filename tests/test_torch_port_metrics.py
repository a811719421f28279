"""The PyTorch port's metrics (`diffusion_models_collection_tpu_torch/
metrics/`) against the JAX package's, on the CPU.

The same numpy inputs from a seed go through the JAX function and its
counterpart in the port, with shared weights where a network is involved:
JAX's own random InceptionV3 and AlexNet, carried across by
`utils/weights.py`'s `inception_state_dict_from_jax` and
`alexnet_state_dict_from_jax` into `.npz` files that both packages' loaders
read. Bars: the networks 2e-4 max-rel; FID's host arithmetic bit-equal (it
is the same numpy code); IS 1e-6; KID's subsets identical and its values
within an absolute bar scaled by the mean cross kernel (MMD^2 is a
difference of near-equal sums); precision/recall equal; SWD's pyramid
1e-5 and its patch and projection steps, fed JAX's draws, 1e-4.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import linalg
from threadpoolctl import threadpool_limits

from diffusion_models_collection_tpu.metrics import fid as jax_fid
from diffusion_models_collection_tpu.metrics import inception as jax_inception
from diffusion_models_collection_tpu.metrics import (
    inception_score as jax_is,
)
from diffusion_models_collection_tpu.metrics import kid as jax_kid
from diffusion_models_collection_tpu.metrics import lpips_score as jax_lpips
from diffusion_models_collection_tpu.metrics import (
    precision_recall as jax_pr,
)
from diffusion_models_collection_tpu.metrics import swd as jax_swd
from diffusion_models_collection_tpu_torch.metrics import fid, inception
from diffusion_models_collection_tpu_torch.metrics import (
    inception_score,
    kid,
    lpips_score,
    precision_recall,
    swd,
)
from diffusion_models_collection_tpu_torch.utils.weights import (
    alexnet_state_dict_from_jax,
    inception_state_dict_from_jax,
)
from torch_port_helpers import max_rel, one_torch_thread  # noqa: F401

TOL_NET = 2e-4


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    """FID's scipy sqrtm at 2048x2048 takes about 15 s on one BLAS thread
    and 12 s on eight; under six test workers, eight threads each would
    oversubscribe the cores."""
    with threadpool_limits(1):
        yield


def images01(seed, shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def grad_imgs(n, seed, size=32):
    """Diagonal-free gradients plus a little noise: one 'distribution'."""
    r = np.random.default_rng(seed)
    base = np.linspace(0, 1, size, dtype=np.float32)
    return np.clip(r.random((n, size, size, 3), dtype=np.float32) * 0.25
                   + 0.75 * base[None, :, None, None], 0, 1)


@pytest.fixture(scope="module")
def jax_features():
    """The JAX package's uncalibrated InceptionV3 (its own init from
    PRNGKey(0), conv kernels times sqrt(2))."""
    return jax_inception.InceptionFeatures()


@pytest.fixture(scope="module")
def inception_npz(jax_features, tmp_path_factory):
    """JAX's random InceptionV3 as an .npz of torchvision keys."""
    path = tmp_path_factory.mktemp("inception") / "inception_v3.npz"
    np.savez(path, **inception_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_features.params)))
    return path


@pytest.fixture(scope="module")
def lpips_npz(tmp_path_factory):
    """JAX's random AlexNet (LPIPSScore's own init from PRNGKey(0)) and
    seeded positive lins, in the .npz layout both loaders read."""
    params = jax_lpips.LPIPSScore().params
    rng = np.random.default_rng(5)
    arrays = {}
    for i in range(1, 6):
        arrays[f"conv{i}_kernel"] = np.asarray(params[f"conv{i}"]["kernel"])
        arrays[f"conv{i}_bias"] = (np.asarray(params[f"conv{i}"]["bias"])
                                   + 0.01 * rng.standard_normal(
                                       params[f"conv{i}"]["bias"].shape)
                                   .astype(np.float32))
    for i, c in enumerate(lpips_score._ALEX_CHANNELS):
        arrays[f"lin{i}"] = rng.random(c, dtype=np.float32) / c
    path = tmp_path_factory.mktemp("lpips") / "lpips_alex.npz"
    np.savez(path, **arrays)
    return path


# ------------------------------------------------------------- InceptionV3
def test_inception_v3_matches_jax(jax_features, inception_npz):
    """Pool features and logits at 2e-4 on 2 images at 299, 2 at 32x32
    (the resize path) and 1 grayscale 32x32, with JAX's random weights;
    `preprocess` itself at 1e-5. `FIDScore.compute_statistics` at 2e-4 on
    the same batch."""
    parts = [images01(0, (2, 32, 32, 3)), images01(1, (1, 32, 32, 1)),
             images01(2, (2, 299, 299, 3))]
    pre_jax = [np.asarray(jax.jit(jax_inception.preprocess)(p))
               for p in parts]
    pre_port = [inception.preprocess(torch.from_numpy(p)).numpy()
                for p in parts]
    for ours, ref in zip(pre_port, pre_jax):
        assert ours.shape == ref.shape == (len(ref), 299, 299, 3)
        np.testing.assert_allclose(ours, ref, atol=1e-5)

    # one JAX compile: the 5 preprocessed images, back in [0, 1] (the
    # 299 -> 299 resize is the identity)
    batch01 = (np.concatenate(pre_jax) + 1.0) / 2.0
    feats_jax, logits_jax = (np.asarray(a) for a in jax_features._run(
        jax_features.params, batch01))
    ours = inception.InceptionFeatures(inception_npz)
    assert ours.calibrated
    feats, logits = (a.numpy() for a in ours(batch01))
    assert feats.shape == (5, 2048) and logits.shape == (5, 1000)
    assert feats.dtype == np.float32
    assert np.std(feats_jax) > 1e-2  # the features did not collapse
    assert max_rel(feats, feats_jax) <= TOL_NET
    assert max_rel(logits, logits_jax) <= TOL_NET
    # the raw images through the port's own preprocessing
    raw = np.concatenate([ours(p)[0].numpy() for p in parts])
    assert max_rel(raw, feats_jax) <= TOL_NET

    mu_j, sig_j = jax_fid.FIDScore(
        feature_fn=lambda b: jax_features._run(jax_features.params, b)[0]
    ).compute_statistics(batch01, batch_size=5)
    mu, sig = fid.FIDScore(inception=ours).compute_statistics(batch01,
                                                              batch_size=5)
    assert max_rel(mu, mu_j) <= TOL_NET and max_rel(sig, sig_j) <= TOL_NET


def torchvision_inception_state(seed):
    """Every key of a torchvision inception_v3 state dict, with seeded
    values: the port's keys plus `num_batches_tracked` of each BatchNorm and
    the auxiliary classifier's (`AuxLogits.*`)."""
    rng = np.random.default_rng(seed)
    state = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
             for k, v in inception.InceptionV3().state_dict().items()}
    for k in list(state):
        if k.endswith("bn.running_var"):
            state[k] = np.abs(state[k]) + 0.5
            state[k.replace("running_var", "num_batches_tracked")] = (
                np.asarray(7, np.int64))
    for name, shape in (("AuxLogits.conv0.conv.weight", (128, 768, 1, 1)),
                        ("AuxLogits.conv0.bn.weight", (128,)),
                        ("AuxLogits.conv0.bn.num_batches_tracked", ()),
                        ("AuxLogits.fc.weight", (1000, 768)),
                        ("AuxLogits.fc.bias", (1000,))):
        state[name] = rng.standard_normal(shape).astype(np.float32)
    return state


def test_inception_loader_drops_what_jax_drops(tmp_path):
    """An .npz of every torchvision key through both loaders: the port keeps
    exactly the tensors JAX keeps (bit for bit, through the inverse bridge),
    drops `AuxLogits.*` and `num_batches_tracked`, and loads the rest with
    strict=True; a missing key fails the strict load."""
    state = torchvision_inception_state(3)
    path = tmp_path / "tv.npz"
    np.savez(path, **state)
    ours = inception.load_torchvision_weights(path)
    ref = inception_state_dict_from_jax(
        jax_inception.load_torchvision_weights(path))
    assert set(ours) == set(ref) == {
        k for k in state
        if not k.startswith("AuxLogits") and "num_batches_tracked" not in k}
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), ref[k], err_msg=k)
    model = inception.InceptionV3()
    model.load_state_dict(ours, strict=True)
    ours.pop("Mixed_6b.branch7x7_2.conv.weight")
    with pytest.raises(RuntimeError, match="Missing key"):
        inception.InceptionV3().load_state_dict(ours, strict=True)


def test_uncalibrated_inception_does_not_collapse():
    """The port's own random InceptionV3 (flax's distribution from a torch
    generator, conv kernels times sqrt(2)): FID between two clearly
    different sets far above FID between two sets of one distribution.
    tr sqrtm(S1 S2) is computed as the nuclear norm of A1 A2^T / (n - 1)
    (A the centred features), the same value as scipy's sqrtm at this rank
    (checked first at 64 dimensions), so the test needs no 2048x2048
    sqrtm."""
    def frechet(x, y):
        a, b = x - x.mean(0), y - y.mean(0)
        cross = np.linalg.norm(a @ b.T / (len(x) - 1), ord="nuc")
        diff = x.mean(0) - y.mean(0)
        return (diff @ diff + np.trace(np.cov(x, rowvar=False))
                + np.trace(np.cov(y, rowvar=False)) - 2 * cross)

    small = [np.random.default_rng(s).standard_normal((10, 64)) for s in (0, 1)]
    assert frechet(*small) == pytest.approx(
        fid.FIDScore.calculate_frechet_distance(
            small[0].mean(0), np.cov(small[0], rowvar=False),
            small[1].mean(0), np.cov(small[1], rowvar=False)), rel=1e-6)

    features = inception.InceptionFeatures()
    assert not features.calibrated
    a, a2 = grad_imgs(6, 1), grad_imgs(6, 2)
    b = np.random.default_rng(0).random((6, 32, 32, 3)).astype(np.float32)
    fa, fa2, fb = (features(x)[0].double().numpy() for x in (a, a2, b))
    assert float(np.std(fa)) > 1e-2, "pool features collapsed"
    same, diff = frechet(fa, fa2), frechet(fa, fb)
    assert diff > 50 * max(same, 1e-3), (same, diff)


# -------------------------------------------------------------------- LPIPS
@pytest.mark.parametrize("size", [32, 12])
def test_lpips_matches_jax(lpips_npz, size):
    """compute_lpips and compute_lpips_diversity at 2e-4 with the same
    .npz weights, at 32x32 and at 12x12 (upsampled to 32 inside)."""
    ref = jax_lpips.LPIPSScore(weights_path=str(lpips_npz))
    ours = lpips_score.LPIPSScore(weights_path=str(lpips_npz))
    assert ref.calibrated and ours.calibrated
    x1, x2 = images01(10, (4, size, size, 3)), images01(11, (4, size, size, 3))
    assert max_rel(ours.distance(x1, x2).numpy(),
                   np.asarray(ref._distance(ref.params, ref.lins, x1, x2))
                   ) <= TOL_NET
    assert ours.compute_lpips(x1, x2) == pytest.approx(
        ref.compute_lpips(x1, x2), rel=TOL_NET)
    pool = images01(12, (6, size, size, 3))
    assert ours.compute_lpips_diversity(pool, num_pairs=12) == pytest.approx(
        ref.compute_lpips_diversity(pool, num_pairs=12), rel=TOL_NET)


def test_alexnet_taps_and_normalize_match_jax(lpips_npz):
    """The five ReLU taps (NCHW against JAX's NHWC) and `_normalize_tensor`
    at 2e-4."""
    ref = jax_lpips.LPIPSScore(weights_path=str(lpips_npz))
    ours = lpips_score.LPIPSScore(weights_path=str(lpips_npz))
    x = images01(13, (2, 32, 32, 3)) * 2 - 1
    taps_ref = ref.model.apply({"params": ref.params}, x)
    with torch.no_grad():
        taps = ours.model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for t, r in zip(taps, taps_ref):
        got = t.permute(0, 2, 3, 1).numpy()
        assert max_rel(got, np.asarray(r)) <= TOL_NET
        assert max_rel(
            lpips_score._normalize_tensor(t).permute(0, 2, 3, 1).numpy(),
            np.asarray(jax_lpips._normalize_tensor(r))) <= TOL_NET


def lpips_layout(arrays, layout):
    """The .npz arrays as a torch state dict in the lpips package's layout
    (`net.sliceK.N`, `linJ.model.1.weight`) or torchvision alexnet's
    (`features.N`, no lins)."""
    slices = {0: 1, 3: 2, 6: 3, 8: 4, 10: 5}
    state = {}
    for i, idx in enumerate((0, 3, 6, 8, 10), start=1):
        prefix = (f"net.slice{slices[idx]}.{idx}" if layout == "lpips"
                  else f"features.{idx}")
        state[f"{prefix}.weight"] = torch.from_numpy(np.ascontiguousarray(
            arrays[f"conv{i}_kernel"].transpose(3, 2, 0, 1)))
        state[f"{prefix}.bias"] = torch.from_numpy(arrays[f"conv{i}_bias"])
    if layout == "lpips":
        for i in range(5):
            state[f"lin{i}.model.1.weight"] = torch.from_numpy(
                arrays[f"lin{i}"]).reshape(1, -1, 1, 1)
    return state


@pytest.mark.parametrize("layout", ["lpips", "torchvision"])
def test_lpips_state_layouts_match_jax(lpips_npz, tmp_path, layout):
    """`convert_lpips_state` on both layouts and `load_lpips_weights` on a
    .pth of each: the same AlexNet (through the inverse bridge) and lins as
    the JAX loaders (uniform 1/C where the layout has none); an
    unparseable state raises the same ValueError."""
    with np.load(lpips_npz) as data:
        arrays = dict(data)
    state = lpips_layout(arrays, layout)
    path = tmp_path / f"{layout}.pth"
    torch.save(state, path)
    for ours, ref in ((lpips_score.convert_lpips_state(state),
                       jax_lpips.convert_lpips_state(state)),
                      (lpips_score.load_lpips_weights(path),
                       jax_lpips.load_lpips_weights(path))):
        ref_alex = alexnet_state_dict_from_jax(ref["alex"])
        assert set(ours["alex"]) == set(ref_alex)
        for k, v in ref_alex.items():
            np.testing.assert_array_equal(ours["alex"][k].numpy(), v)
        for a, b in zip(ours["lins"], ref["lins"]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    lpips_score.AlexNetFeatures().load_state_dict(ours["alex"], strict=True)
    bad = {"net.slice1.0.weight": state[next(iter(state))]}
    with pytest.raises(ValueError) as ours_err:
        lpips_score.convert_lpips_state(bad)
    with pytest.raises(ValueError) as ref_err:
        jax_lpips.convert_lpips_state(bad)
    assert str(ours_err.value) == str(ref_err.value)


# ---------------------------------------------------------------------- FID
def spd(seed, dim):
    a = np.random.default_rng(seed).normal(size=(dim, dim))
    return a @ a.T + 0.5 * np.eye(dim)


@pytest.mark.parametrize("n_real,n_fake", [(100, 80), (40, 30)])
def test_frechet_distance_is_bit_equal(n_real, n_fake):
    """The same features give the same FID to the last bit, also where the
    covariances are singular (N < D: the eps-offset retry's ground)."""
    rng = np.random.default_rng(n_real)
    x = rng.standard_normal((n_real, 64))
    y = rng.standard_normal((n_fake, 64)) * 1.3 + 0.2
    args = (x.mean(0), np.cov(x, rowvar=False), y.mean(0),
            np.cov(y, rowvar=False))
    ours = fid.FIDScore.calculate_frechet_distance(*args)
    ref = jax_fid.FIDScore.calculate_frechet_distance(*args)
    assert ours == ref and np.isfinite(ours)


def test_newton_schulz_trace_sqrtm_against_scipy():
    """tr sqrtm of an SPD product, 50 iterations, float32: the port's and
    JAX's within 1e-3 of scipy (the JAX package's own bar; measured here:
    both about 1e-6), and within 1e-5 of each other."""
    prod = spd(0, 16) @ spd(1, 16)
    ref = np.trace(linalg.sqrtm(prod).real)
    ours = fid.FIDScore.trace_sqrtm_newton_schulz(prod, iters=50)
    theirs = jax_fid.FIDScore.trace_sqrtm_newton_schulz(prod, iters=50)
    assert ours == pytest.approx(ref, rel=1e-3)
    assert ours == pytest.approx(theirs, rel=1e-5)


# ----------------------------------------------------------------------- IS
@pytest.mark.parametrize("n", [50, 5])
def test_inception_score_matches_jax(n):
    """The same logits give the same (mean, std) at 1e-6; with fewer images
    than the 10 splits both are NaN. The 'images' carry their row index,
    which the logits function looks up."""
    logits = np.random.default_rng(n).standard_normal((n, 20)).astype(
        np.float32) * 3
    images = np.arange(n, dtype=np.float32).reshape(n, 1, 1, 1)

    def lookup(batch):
        return logits[np.asarray(batch)[:, 0, 0, 0].astype(int)]

    ours = inception_score.InceptionScore(
        logits_fn=lookup).compute_inception_score(images, batch_size=8)
    ref = jax_is.InceptionScore(
        logits_fn=lambda b: jnp.asarray(lookup(b))).compute_inception_score(
            images, batch_size=8)
    if n < 10:
        assert all(math.isnan(v) for v in (*ours, *ref))
    else:
        np.testing.assert_allclose(ours, ref, rtol=1e-6)


# ---------------------------------------------------------------------- KID
def test_kid_subsets_and_values_match_jax(monkeypatch):
    """The subsets the port evaluates are the rows JAX's index arrays pick,
    subset by subset; mean and std agree within 1e-5 x mean(k_xy) absolute
    (each subset's MMD^2 is a difference of sums of m^2 kernel values near
    mean(k_xy), so a relative bar on the difference would measure float32
    cancellation, not the port)."""
    rng = np.random.default_rng(0)
    real = rng.standard_normal((40, 32)).astype(np.float32)
    fake = (rng.standard_normal((30, 32)) * 1.1 + 0.1).astype(np.float32)

    jax_idx = []
    jax_over = jax_kid._mmd2_over_subsets
    monkeypatch.setattr(jax_kid, "_mmd2_over_subsets",
                        lambda r, f, ir, jf: (jax_idx.append(
                            (np.asarray(ir), np.asarray(jf)))
                            or jax_over(r, f, ir, jf)))
    port_rows = []
    port_mmd = kid._mmd2_unbiased
    monkeypatch.setattr(kid, "_mmd2_unbiased",
                        lambda x, y: (port_rows.append((x.numpy(), y.numpy()))
                                      or port_mmd(x, y)))
    ref = jax_kid.KIDScore(subset_size=25, subsets=7, seed=3
                           ).compute_from_features(real, fake)
    ours = kid.KIDScore(subset_size=25, subsets=7, seed=3
                        ).compute_from_features(real, fake)
    (idx_real, idx_fake), = jax_idx
    assert len(port_rows) == 7
    for s, (x, y) in enumerate(port_rows):
        np.testing.assert_array_equal(x, real[idx_real[s]])
        np.testing.assert_array_equal(y, fake[idx_fake[s]])
    scale = float(kid.polynomial_kernel(torch.from_numpy(real),
                                        torch.from_numpy(fake)).mean())
    assert abs(ours[0] - ref[0]) <= 1e-5 * scale, (ours, ref, scale)
    assert abs(ours[1] - ref[1]) <= 1e-5 * scale, (ours, ref, scale)
    np.testing.assert_allclose(
        kid.polynomial_kernel(torch.from_numpy(real), torch.from_numpy(fake)),
        jax_kid.polynomial_kernel(jnp.asarray(real), jnp.asarray(fake)),
        rtol=1e-5)


@pytest.mark.parametrize("kwargs,real_shape,fake_shape", [
    ({"subset_size": 1}, (4, 3), (4, 3)),
    ({"subsets": 0}, (4, 3), (4, 3)),
    ({}, (4,), (4, 3)),
    ({}, (1, 3), (4, 3)),
])
def test_kid_errors_match_jax(kwargs, real_shape, fake_shape):
    errors = []
    for module in (kid, jax_kid):
        with pytest.raises(ValueError) as err:
            module.KIDScore(feature_fn=lambda b: b, **kwargs
                            ).compute_from_features(np.zeros(real_shape),
                                                    np.zeros(fake_shape))
        errors.append(str(err.value))
    assert errors[0] == errors[1]


# ---------------------------------------------------------- precision/recall
@pytest.mark.parametrize("k", [1, 3, 5])
def test_precision_recall_matches_jax(k):
    rng = np.random.default_rng(k)
    real = rng.standard_normal((60, 16)).astype(np.float32)
    fake = (rng.standard_normal((50, 16)) * 0.8 + 0.3).astype(np.float32)
    ours = precision_recall.PrecisionRecall(
        k=k, feature_fn=lambda b: b).compute_from_features(real, fake)
    ref = jax_pr.PrecisionRecall(
        k=k, feature_fn=lambda b: b).compute_from_features(real, fake)
    # the same points inside each manifest (the float32 means of the
    # indicators may differ in their last bit)
    assert round(ours[0] * 50) == round(ref[0] * 50)
    assert round(ours[1] * 60) == round(ref[1] * 60)
    np.testing.assert_allclose(ours, ref, rtol=1e-6)
    assert 0.0 < ours[1] < 1.0


@pytest.mark.parametrize("k,n_real", [(0, 10), (3, 3)])
def test_precision_recall_errors_match_jax(k, n_real):
    errors = []
    for module in (precision_recall, jax_pr):
        with pytest.raises(ValueError) as err:
            module.PrecisionRecall(k=k, feature_fn=lambda b: b
                                   ).compute_from_features(
                np.zeros((n_real, 4)), np.zeros((10, 4)))
        errors.append(str(err.value))
    assert errors[0] == errors[1]


# ---------------------------------------------------------------------- SWD
def test_laplacian_pyramid_matches_jax():
    x = grad_imgs(2, 4)
    ours = swd.laplacian_pyramid(torch.from_numpy(x), 3)
    ref = jax_swd.laplacian_pyramid(jnp.asarray(x), 3)
    assert [tuple(p.shape) for p in ours] == [p.shape for p in ref]
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_patches_and_sliced_w1_match_jax_with_its_draws():
    """`_extract_patches` and `_sliced_w1` fed the positions and the
    directions JAX draws from its keys, at 1e-4."""
    level = jnp.asarray(grad_imgs(3, 5, size=16))
    key = jax.random.PRNGKey(7)
    ref = jax_swd._extract_patches(level, key, 10)
    ky, kx = jax.random.split(key)
    ys = jax.random.randint(ky, (3, 10), 0, 16 - swd.PATCH + 1)
    xs = jax.random.randint(kx, (3, 10), 0, 16 - swd.PATCH + 1)
    ours = swd._extract_patches(
        torch.from_numpy(np.asarray(level)),
        *(torch.from_numpy(np.asarray(a, np.int64)) for a in (ys, xs)))
    assert ours.shape == (30, swd.PATCH * swd.PATCH * 3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)

    fake = jnp.asarray(np.random.default_rng(6).random(ref.shape,
                                                       dtype=np.float32))
    dkey = jax.random.PRNGKey(8)
    dirs = jax.random.normal(dkey, (ref.shape[1], 32))
    got = swd._sliced_w1(torch.from_numpy(np.asarray(ref)),
                         torch.from_numpy(np.asarray(fake)),
                         torch.from_numpy(np.asarray(dirs)))
    want = jax_swd._sliced_w1(ref, fake, dkey, 32)
    assert float(got) == pytest.approx(float(want), rel=1e-4)


def test_swd_keys_and_resolution_error_match_jax():
    """The per-level keys of a 32x32 run (the draws differ between the
    packages, so the values do) and the resolution-mismatch ValueError."""
    a, b = grad_imgs(4, 1), grad_imgs(4, 2)
    ours = swd.compute_swd(a, b, seed=3)
    assert set(ours) == set(jax_swd.compute_swd(a, b, seed=3))
    assert ours == swd.compute_swd(a, b, seed=3)  # seeded: reproducible
    errors = []
    for module in (swd, jax_swd):
        with pytest.raises(ValueError) as err:
            module.compute_swd(a, grad_imgs(4, 2, size=16))
        errors.append(str(err.value))
    assert errors[0] == errors[1]


# ----------------------------------------------------- calculate_all_metrics
def test_calculate_all_metrics_matches_jax(inception_npz, lpips_npz,
                                          monkeypatch):
    """The same 20 real and 20 fake 32x32 images (one shape: one JAX
    compile, shared with the next test) and the same .npz weights
    on both sides: the same keys in the same order, every value within its
    bar, no manifest. FID, IS and LPIPS at 1e-4 relative (measured: FID
    3e-6 with scipy's sqrtm, the others below 2e-7), IS_std at 1e-2 (it is
    4e-5 here, and 1e-4 apart), KID within 1e-4 x mean(k_xy) absolute
    (measured 7e-7 x). scipy's 2048x2048 sqrtm (15 s a call on one core,
    covered bit for bit above and run for real by the evaluate CLI's test)
    is replaced on both sides by the square root of the product's diagonal,
    so FID still compares every feature statistic it reads."""
    monkeypatch.setattr(linalg, "sqrtm", lambda m, disp=True: (
        np.diag(np.sqrt(np.abs(np.diagonal(m)))) if disp
        else (np.diag(np.sqrt(np.abs(np.diagonal(m)))), 0.0)))
    real, fake = grad_imgs(20, 8), images01(9, (20, 32, 32, 3))
    ref = jax_lpips.calculate_all_metrics(
        real, fake, weights_path=str(inception_npz),
        lpips_weights_path=str(lpips_npz))
    ours = lpips_score.calculate_all_metrics(
        real, fake, weights_path=str(inception_npz),
        lpips_weights_path=str(lpips_npz))
    assert list(ours) == list(ref)
    assert "_uncalibrated" not in ours
    assert ours["precision_recall_skipped_below_n"] == 1000
    for key in ("FID", "IS_mean", "LPIPS_diversity"):
        assert ours[key] == pytest.approx(ref[key], rel=1e-4), key
    assert ours["IS_std"] == pytest.approx(ref["IS_std"], rel=1e-2,
                                           abs=1e-6)
    # mean(k_xy) over the first five images of each set, as the scale
    features = inception.InceptionFeatures(str(inception_npz))
    scale = float(kid.polynomial_kernel(features(real[:5])[0],
                                        features(fake[:5])[0]).mean())
    for key in ("KID_mean", "KID_std"):
        assert abs(ours[key] - ref[key]) <= 1e-4 * scale, key


def test_calculate_all_metrics_uncalibrated_manifest_matches_jax(
        monkeypatch):
    """With no weights both packages label the same keys relative-only
    (the values differ: each side draws its own random weights). The host
    sqrtm, whose value does not enter the manifest, is replaced on both
    sides by a cheap stand-in."""
    monkeypatch.setattr(linalg, "sqrtm",
                        lambda m, disp=True: (np.eye(len(m)), 0.0)
                        if not disp else np.eye(len(m)))
    monkeypatch.delenv(inception.WEIGHTS_ENV_VAR, raising=False)
    monkeypatch.delenv(lpips_score.WEIGHTS_ENV_VAR, raising=False)
    real, fake = images01(20, (20, 32, 32, 3)), images01(21, (20, 32, 32, 3))
    ref = jax_lpips.calculate_all_metrics(real, fake)
    ours = lpips_score.calculate_all_metrics(real, fake)
    assert list(ours) == list(ref)
    assert ours["_uncalibrated"] == ref["_uncalibrated"] == [
        "FID", "KID_mean", "KID_std", "IS_mean", "IS_std", "LPIPS_diversity"]
