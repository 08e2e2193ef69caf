"""Serving export on the CPU: K1 as the op ``endodepth::fused_dense_conv``,
the port's ``torch.export`` artifact against the live predictor and the
JAX package's ``export`` artifact, the AOTInductor bundle against JAX's
``export_pjrt_bundle``, and the libtorch host ``csrc/serve_host.cpp``. At
64x64, f32, from one JAX-seeded reference-format .pt."""
import json
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from endoscopydepthestimation_pytorch_tpu import serving as jax_serving
from endoscopydepthestimation_pytorch_tpu.models import FCDenseNet57 as JaxFCDenseNet57
from endoscopydepthestimation_pytorch_tpu.models.torch_import import save_reference_checkpoint
from endoscopydepthestimation_pytorch_tpu_torch import serving
from endoscopydepthestimation_pytorch_tpu_torch.ops import _build, _libtorch_build, dense_conv

from torch_port_cases import seeded_jax_state

H = W = 64
B = 2
TOL = dict(rtol=2e-4, atol=1e-4)  # against JAX: 44 dense layers of f32 sums in another order
# against the live predictor: the artifacts run the same CPU kernels
# (measured: equal to the last bit, so the limit is f32 rounding only)
SAME = dict(rtol=1e-5, atol=1e-6)
OP = torch.ops.endodepth.fused_dense_conv.default


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    state = seeded_jax_state(JaxFCDenseNet57(n_classes=1), (1, H, W, 3), seed=9)
    path = tmp_path_factory.mktemp("export") / "seeded.pt"
    save_reference_checkpoint(path, {"params": state.params,
                                     "batch_stats": state.batch_stats})
    return path


@pytest.fixture(scope="module")
def predictor(checkpoint):
    return serving.DepthPredictor(checkpoint, chip_smoke.synthetic_sequence(H, W),
                                  batch_size=B, downsampling=1.0, device="cpu",
                                  dtype=torch.float32)


@pytest.fixture(scope="module")
def colors(predictor):
    frames = chip_smoke.synthetic_frames(B, H, W, seed=5)
    return np.stack([predictor.prepare(f) for f in frames])


@pytest.fixture(scope="module")
def exported(predictor, tmp_path_factory):
    path = tmp_path_factory.mktemp("exported") / "depth.pt2"
    predictor.export(path)
    return path


@pytest.fixture(scope="module")
def bundle(predictor, tmp_path_factory):
    path = tmp_path_factory.mktemp("bundle")
    predictor.export_native_bundle(path)
    return path


def _op_inputs(b, h, w, c, f, seed):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)),
            torch.from_numpy((rng.rand(c) + 0.5).astype(np.float32)),
            torch.from_numpy((rng.randn(c) * 0.3).astype(np.float32)),
            torch.from_numpy((rng.randn(3, 3, c, f) * 0.2).astype(np.float32)),
            torch.from_numpy(rng.randn(f).astype(np.float32)))


@pytest.mark.parametrize("shape,with_bias", [((2, 5, 7, 20, 12), True),
                                             ((1, 6, 4, 9, 5), False)])
def test_op_passes_opcheck_and_is_the_plain_version_on_the_cpu(shape, with_bias):
    x, scale, shift, w, bias = _op_inputs(*shape, seed=sum(shape))
    bias = bias if with_bias else None
    args = (x, scale, shift, w, bias, *dense_conv.forward_tiling(x.dtype, *x.shape))
    result = torch.library.opcheck(OP, args)
    assert set(result.values()) == {"SUCCESS"}, result
    got = OP(*args)
    assert got.is_contiguous()
    assert torch.equal(got, dense_conv.fused_dense_conv_reference(x, scale, shift, w, bias))
    assert torch.equal(got, dense_conv.fused_dense_conv(x, scale, shift, w, bias))


def test_op_raises_on_other_strides_and_tilings():
    """The op never copies an x it cannot take: a non-contiguous one raises,
    and so does a tiling no kernel has."""
    x, scale, shift, w, bias = _op_inputs(1, 6, 5, 8, 4, seed=3)
    nchw = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    with pytest.raises(ValueError, match="contiguous"):
        OP(nchw, scale, shift, w, bias, 16, 32, 1)
    with pytest.raises(ValueError, match="tiling"):
        OP(x, scale, shift, w, bias, 8, 32, 1)
    with pytest.raises(ValueError, match="tiling"):
        OP(x.bfloat16(), scale, shift, w.bfloat16(), bias, 16, 32, 0)
    assert torch.Tag.needs_exact_strides in OP.tags or \
        torch.Tag.needs_fixed_stride_order in OP.tags


def test_export_round_trip_matches_predict_batch(predictor, colors, exported):
    program = torch.export.load(str(exported))
    k1 = [n for n in program.graph.nodes if n.target is OP]
    assert len(k1) == 44  # every dense layer an opaque K1 node
    got = serving.load_exported(exported, device="cpu")(colors)
    assert got.shape == (B, H, W, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got[..., 0].numpy(), predictor.predict_batch(colors), **SAME)


def test_export_round_trip_with_a_one_pixel_bottleneck(checkpoint, tmp_path):
    """At 32x32 the bottleneck is 1x1, a map whose strides fit NCHW and
    channels_last alike: the replayed artifact still hands every K1 an
    NHWC-contiguous x (the trace's layouts are the run's)."""
    small = serving.DepthPredictor(checkpoint, chip_smoke.synthetic_sequence(32, 32),
                                   batch_size=1, downsampling=1.0, device="cpu",
                                   dtype=torch.float32)
    colors = np.random.RandomState(4).randn(1, 32, 32, 3).astype(np.float32)
    small.export(tmp_path / "small.pt2")
    got = serving.load_exported(tmp_path / "small.pt2", device="cpu")(colors)
    np.testing.assert_allclose(got[..., 0].numpy(), small.predict_batch(colors), **SAME)


def test_load_exported_refuses_another_device(exported):
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="exported on"):
            serving.load_exported(exported)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serving.load_exported(exported)


def test_exported_artifact_matches_jax_export(checkpoint, colors, exported, tmp_path):
    want = jax_serving.DepthPredictor(checkpoint, chip_smoke.synthetic_sequence(H, W),
                                      batch_size=B, downsampling=1.0, dtype=jnp.float32,
                                      packed=False)
    want.export(tmp_path / "jax.exp")
    jax_depth = np.asarray(jax_serving.load_exported(tmp_path / "jax.exp")(
        jnp.asarray(colors)))
    got = serving.load_exported(exported, device="cpu")(colors).numpy()
    assert got.shape == jax_depth.shape == (B, H, W, 1)
    np.testing.assert_allclose(got, jax_depth, **TOL)


def _meta(path):
    return dict(line.split("=", 1) for line in (path / "meta.txt").read_text().splitlines())


def test_native_bundle_matches_jax_bundle_and_predict_batch(
        checkpoint, predictor, colors, bundle, tmp_path, monkeypatch):
    want = jax_serving.DepthPredictor(checkpoint, chip_smoke.synthetic_sequence(H, W),
                                      batch_size=B, downsampling=1.0, dtype=jnp.float32,
                                      packed=False)
    want.export_pjrt_bundle(tmp_path / "pjrt", platform="cpu")
    got_meta, want_meta = _meta(bundle), _meta(tmp_path / "pjrt")
    assert got_meta.pop("platform") == "cpu"
    want_meta.pop("platform")
    assert got_meta == want_meta
    assert (bundle / "model.pt2").read_bytes()[:4] == b"PK\x03\x04"
    assert (bundle / "ops.so").read_bytes() == _libtorch_build.op_library().read_bytes()

    # the package calls K1 by name: each dense layer reaches the Python op
    calls = []
    original = dense_conv.fused_dense_conv_reference

    def spy(x, *args):
        calls.append(tuple(x.shape))
        return original(x, *args)

    monkeypatch.setattr(dense_conv, "fused_dense_conv_reference", spy)
    package = torch._inductor.aoti_load_package(str(bundle / "model.pt2"))
    got = package(torch.from_numpy(colors))
    assert len(calls) == 44
    np.testing.assert_allclose(got[..., 0].numpy(), predictor.predict_batch(colors), **SAME)


def _host(*args, **kwargs):
    return subprocess.run([str(serving.build_native_host()), *map(str, args)],
                          capture_output=True, timeout=120, **kwargs)


def test_native_host_contract(bundle):
    """``--help`` and ``--parse-only`` answer as JAX's PJRT host does in
    ``test_pjrt_bundle_export``."""
    out = _host("--help", text=True)
    assert out.returncode == 0 and "--bundle" in out.stdout
    out = _host("--parse-only", "--bundle", bundle, text=True)
    assert out.returncode == 0, out.stderr
    parsed = json.loads(out.stdout)
    assert parsed["platform"] == "cpu"
    assert parsed["inputs"] == 1 and parsed["outputs"] == 1
    assert parsed["input0_bytes"] == B * H * W * 3 * 4
    assert parsed["output0_bytes"] == B * H * W * 1 * 4
    assert parsed["module_bytes"] == (bundle / "model.pt2").stat().st_size


def test_native_host_serves_the_cpu_bundle(predictor, colors, bundle, tmp_path):
    (tmp_path / "in.bin").write_bytes(np.ascontiguousarray(colors, np.float32).tobytes())
    out = _host("--bundle", bundle, "--device", "cpu", "--iters", 2, "--warmup", 1,
                "--input", tmp_path / "in.bin", "--output", tmp_path / "out.bin", text=True)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout)
    assert report["batch"] == B and report["iters"] == 2 and report["device"] == "cpu"
    assert report["k1_launches"] == 0  # the CPU's plain version launches nothing
    depth = np.fromfile(tmp_path / "out.bin", np.float32).reshape(B, H, W)
    want = predictor.predict_batch(colors)
    np.testing.assert_allclose(depth, want, **SAME)

    # --stream: three batches on stdin, each one's depth on stdout in order
    batches = [colors, colors[::-1], colors * 0.5]
    out = _host("--bundle", bundle, "--device", "cpu", "--stream",
                input=b"".join(np.ascontiguousarray(c, np.float32).tobytes()
                               for c in batches))
    assert out.returncode == 0, out.stderr.decode()
    streamed = np.frombuffer(out.stdout, np.float32).reshape(3, B, H, W)
    stats = json.loads(out.stderr.decode().strip().splitlines()[-1])
    assert stats["batches"] == 3
    for got, c in zip(streamed, batches):
        np.testing.assert_allclose(got, predictor.predict_batch(np.ascontiguousarray(c)),
                                   **SAME)


def test_native_host_refuses_cuda_without_a_card(bundle, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the host without a card")
    out = _host("--bundle", bundle, "--device", "cuda", text=True)
    assert out.returncode != 0 and "--device cuda" in out.stderr
    # a device the host does not know, and a bundle for another platform
    assert _host("--bundle", bundle, "--device", "tpu").returncode != 0
    cuda_bundle = tmp_path / "cuda_bundle"
    shutil.copytree(bundle, cuda_bundle)
    meta = (cuda_bundle / "meta.txt").read_text().replace("platform=cpu", "platform=cuda")
    (cuda_bundle / "meta.txt").write_text(meta)
    out = _host("--bundle", cuda_bundle, "--device", "cpu", text=True)
    assert out.returncode != 0 and "compiled for cuda" in out.stderr


def test_cpp_schema_is_the_python_ops():
    """``csrc/dense_conv_op.cpp`` defines the op with the Python schema
    (the host's proxy executor calls the C++ one by that schema)."""
    source = (_build.CSRC / "dense_conv_op.cpp").read_text()
    block = re.search(r"m\.def\(((?:\s*\"[^\"]*\")+)\)", source).group(1)
    cpp = "".join(re.findall(r"\"([^\"]*)\"", block))
    assert cpp == dense_conv.SCHEMA
    assert str(OP._schema) == "endodepth::" + cpp


def test_libtorch_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    """A source g++ refuses raises with g++'s output, and leaves nothing
    to load."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    (csrc / "serve_host.cpp").write_text("int main() { return undeclared; }\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_libtorch_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="undeclared"):
        _libtorch_build.host_binary()
    assert not list((tmp_path / "build").iterdir())
