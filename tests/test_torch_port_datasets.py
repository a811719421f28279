"""The port's own datasets and loader against the JAX package's, bit for bit,
and the port's independence of the JAX package.

`diffusion_models_collection_tpu_torch/datasets/` is a copy of the JAX
package's framework-free `datasets/` (numpy, ctypes, the standard library),
kept so that the port imports nothing of that package. The same dataset,
transform, loader settings and seed must give equal batches from both, on
the committed CIFAR-10 and MNIST fixtures, on `synthetic`, and on an image
folder; and every module of the port, with its CLIs, must import with
`jax` and `diffusion_models_collection_tpu` blocked.
"""

import pkgutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import diffusion_models_collection_tpu.datasets as jax_data
import diffusion_models_collection_tpu_torch
import diffusion_models_collection_tpu_torch.datasets as port_data
from diffusion_models_collection_tpu_torch import factory

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "data"


def batches(data, name, size, train, conditional, loader_kwargs, epochs=2,
            **dataset_kwargs):
    """Every batch of `epochs` epochs from package `data`."""
    dataset = data.DiffusionDataset(
        dataset_name=name, root=str(FIXTURES), train=train,
        transform=data.DiffusionDataset.get_default_transform(
            size, name, train=train),
        conditional=conditional, **dataset_kwargs)
    loader = data.DataLoader(dataset, **loader_kwargs)
    out = []
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        out += list(loader)
    return out


def assert_equal_batches(ours, refs, conditional):
    assert len(ours) == len(refs) > 0
    for (got, labels), (want, want_labels) in zip(ours, refs):
        if conditional:
            np.testing.assert_array_equal(labels, want_labels)
            assert labels.dtype == want_labels.dtype
        else:
            assert labels is None and want_labels is None
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,size,kwargs", [
    ("cifar10", (32, 32), {}),
    ("cifar10", (16, 16), {}),   # resized: the native or the Pillow path
    ("mnist", (28, 28), {}),
    ("synthetic", (64, 64), dict(image_size=(64, 64), channels=3,
                                 num_classes=10)),
    ("synthetic", (16, 16), dict(image_size=(16, 16), channels=3,
                                 num_classes=10)),
])
@pytest.mark.parametrize("train", [True, False])
def test_batches_equal_the_jax_packages(name, size, kwargs, train):
    loader_kwargs = dict(batch_size=48, shuffle=train, drop_last=train,
                         seed=3, num_workers=0)
    args = (name, size, train, True, loader_kwargs)
    assert_equal_batches(batches(port_data, *args, **kwargs),
                         batches(jax_data, *args, **kwargs), True)


@pytest.mark.parametrize("loader_kwargs", [
    dict(batch_size=32, shuffle=True, drop_last=True, seed=0, prefetch=0),
    dict(batch_size=32, shuffle=True, drop_last=True, seed=0, prefetch=2,
         num_workers=2),
    dict(batch_size=50, shuffle=False, drop_last=False, seed=9,
         process_index=1, process_count=2),
    dict(batch_size=32, shuffle=True, drop_last=True, seed=1,
         random_flip=False),
])
def test_loader_options_equal_the_jax_packages(loader_kwargs):
    args = ("cifar10", (32, 32), True, False, loader_kwargs)
    assert_equal_batches(batches(port_data, *args),
                         batches(jax_data, *args), False)


def test_image_folder_batches_equal_the_jax_packages(tmp_path):
    image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(0)
    for label in ("cat", "dog"):
        (tmp_path / label).mkdir()
        for i in range(5):
            image.fromarray(rng.integers(0, 256, (12, 10, 3), dtype=np.uint8)
                            ).save(tmp_path / label / f"{i}.png")
    out = []
    for data in (port_data, jax_data):
        dataset = data.CustomImageDataset(
            root=str(tmp_path), conditional=True, use_subdirs=True,
            transform=data.CustomImageDataset.get_default_transform(
                (8, 8), "rgb", train=True))
        loader = data.DataLoader(dataset, batch_size=4, shuffle=True,
                                 drop_last=True, seed=2)
        out.append(list(loader))
    assert_equal_batches(*out, True)


def test_transforms_equal_the_jax_packages():
    rng = np.random.default_rng(1)
    batch = rng.standard_normal((6, 8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        port_data.flip_batch(batch, np.random.default_rng(2)),
        jax_data.flip_batch(batch, np.random.default_rng(2)))
    image = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
    for train in (True, False):
        ours = port_data.ImageTransform((8, 8), train=train)
        ref = jax_data.ImageTransform((8, 8), train=train)
        assert ours.random_flip == ref.random_flip
        np.testing.assert_array_equal(ours(image), ref(image))


def test_factory_reads_the_ports_own_datasets():
    config = {"dataset": "synthetic", "image_size": (64, 64),
              "conditional": True, "num_classes": 10, "batch_size": 16,
              "num_workers": 0, "model_params": {"in_channels": 3}}
    dataset = factory.get_dataset(config)
    loader = factory.get_dataloader(config, dataset, seed=4)
    assert type(dataset).__module__.startswith(
        "diffusion_models_collection_tpu_torch.datasets")
    assert type(loader).__module__.startswith(
        "diffusion_models_collection_tpu_torch.datasets")
    images, labels = next(iter(loader))
    assert images.shape == (16, 64, 64, 3) and labels.shape == (16,)
    ref = next(iter(jax_data.DataLoader(
        jax_data.DiffusionDataset(
            "synthetic", conditional=True, image_size=(64, 64), channels=3,
            num_classes=10,
            transform=jax_data.DiffusionDataset.get_default_transform(
                (64, 64), "synthetic", train=True)),
        batch_size=16, shuffle=True, drop_last=True, seed=4, num_workers=0)))
    np.testing.assert_array_equal(images, ref[0])
    np.testing.assert_array_equal(labels, ref[1])


def port_modules():
    package = diffusion_models_collection_tpu_torch
    return sorted(
        info.name for info in pkgutil.walk_packages(
            package.__path__, package.__name__ + "."))


def test_every_module_of_the_port_imports_without_jax_or_the_jax_package():
    """In a fresh process that refuses `jax`, `flax`, `optax` and
    `diffusion_models_collection_tpu`: every module of the port, the
    `train`, `sample`, `evaluate` and `serve` CLIs, the serving engine, the
    metrics and the fixture tool among them, the sampler export
    (`serving`) and the kernels' operators (`ops._library`), `chip_smoke.py`'s
    imports and the profiling tools."""
    modules = port_modules()
    assert {"diffusion_models_collection_tpu_torch.train",
            "diffusion_models_collection_tpu_torch.sample",
            "diffusion_models_collection_tpu_torch.evaluate",
            "diffusion_models_collection_tpu_torch.serve",
            "diffusion_models_collection_tpu_torch.serving_engine",
            "diffusion_models_collection_tpu_torch.metrics.inception",
            "diffusion_models_collection_tpu_torch.metrics.fid",
            "diffusion_models_collection_tpu_torch.metrics.inception_score",
            "diffusion_models_collection_tpu_torch.metrics.kid",
            "diffusion_models_collection_tpu_torch.metrics.precision_recall",
            "diffusion_models_collection_tpu_torch.metrics.lpips_score",
            "diffusion_models_collection_tpu_torch.metrics.swd",
            "diffusion_models_collection_tpu_torch.tools.fixture_quality_run",
            "diffusion_models_collection_tpu_torch.datasets.loader",
            "diffusion_models_collection_tpu_torch.ops.selective_scan",
            "diffusion_models_collection_tpu_torch.models.dit",
            "diffusion_models_collection_tpu_torch.ops.attention",
            "diffusion_models_collection_tpu_torch.models.vae",
            "diffusion_models_collection_tpu_torch.utils.latent",
            "diffusion_models_collection_tpu_torch.utils.vae_trainer",
            "diffusion_models_collection_tpu_torch.tools.compute_latent_scale",
            "diffusion_models_collection_tpu_torch.models.classifier",
            "diffusion_models_collection_tpu_torch.utils.classifier_trainer",
            "diffusion_models_collection_tpu_torch.diffusion.guidance",
            "diffusion_models_collection_tpu_torch.utils.sr",
            "diffusion_models_collection_tpu_torch.tools.cascade",
            "diffusion_models_collection_tpu_torch.models.moe",
            "diffusion_models_collection_tpu_torch.ops.tome",
            "diffusion_models_collection_tpu_torch.ops.quant",
            "diffusion_models_collection_tpu_torch.diffusion.consistency",
            "diffusion_models_collection_tpu_torch.diffusion.distill",
            "diffusion_models_collection_tpu_torch.utils.ema",
            "diffusion_models_collection_tpu_torch.utils.optimizers",
            "diffusion_models_collection_tpu_torch.utils.fewstep",
            "diffusion_models_collection_tpu_torch.utils.consistency_trainer",
            "diffusion_models_collection_tpu_torch.utils.distill_trainer",
            "diffusion_models_collection_tpu_torch.utils.reflow_trainer",
            "diffusion_models_collection_tpu_torch.tools.distill",
            "diffusion_models_collection_tpu_torch.tools.reflow",
            "diffusion_models_collection_tpu_torch.serving",
            "diffusion_models_collection_tpu_torch.ops._library",
            } <= set(modules)
    script = textwrap.dedent("""
        import importlib, importlib.abc, runpy, sys

        BLOCKED = ("jax", "flax", "optax", "diffusion_models_collection_tpu")

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"blocked import of {name}")
                return None

        sys.meta_path.insert(0, Block())
        for name in sys.argv[1:]:
            importlib.import_module(name)
        for tool in ("tools/profile_torch_sampling.py",
                     "tools/profile_torch_training.py",
                     "tools/profile_torch_kernels.py",
                     "tools/profile_torch_dispatch.py"):
            runpy.run_path(tool, run_name="not_main")
        loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not loaded, loaded
        print("imported", len(sys.argv) - 1)
    """)
    result = subprocess.run([sys.executable, "-c", script, *modules],
                            cwd=REPO, capture_output=True, text=True,
                            timeout=300)
    assert result.returncode == 0, result.stderr[-2000:]
    assert f"imported {len(modules)}" in result.stdout


def test_no_source_line_of_the_port_imports_the_jax_package():
    import re
    pattern = re.compile(
        r"^\s*(from|import) +(jax|flax|optax|diffusion_models_collection_tpu)\b")
    files = [*(REPO / "diffusion_models_collection_tpu_torch").rglob("*.py"),
             REPO / "chip_smoke.py", *(REPO / "tools").glob("profile_torch_*.py")]
    assert len(files) > 30
    hits = [f"{path.relative_to(REPO)}:{i}: {line.strip()}"
            for path in files
            for i, line in enumerate(path.read_text().splitlines(), 1)
            if pattern.match(line)]
    assert not hits, hits
