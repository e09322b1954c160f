"""The port's profilers (``frido_tpu_torch/tools/profile_step.py`` and
``profile_train.py``, the counterparts of ``scripts/profile_step.py`` and
``scripts/profile_train.py``) on the CPU:

- the categorizer names each of the port's six kernels by its
  ``__global__`` function as the profiler prints it (templates, the conv
  kernel's fused flag), and sorts cuBLAS, cuDNN (its FFT's complex GEMMs
  among them) and PyTorch's own kernels and the CPU's operators into
  GEMM, cuDNN conv, elementwise, reduction/norm and copy/cast;
- ``device_events`` gives each device kernel of a (stand-in) profile the
  shapes of the operator that launched it, by launch order within a
  kernel name, and ``""`` to a kernel no operator lists, and leaves out
  an annotation's device-side range;
- ``summarize`` on a synthetic event list: the total a call, the
  categories' times and shares (summing to 100%), the top kernels in
  order of time with their shapes; the tensor-core table by (kind,
  shape);
- a toy run of each profiler on the CPU prints every unit (the tiny
  models; the CPU's operator times stand in for device kernels), and
  without a card and ``--device cpu`` each raises;
- ``profile_train`` shares ``profile_step``'s capture and report (its
  ``summarize`` and categorizer), as the JAX script imports them.
"""

import pytest
import torch

from frido_tpu_torch.tools import profile_step, profile_train

torch.set_num_threads(2)

PORT = {
    "flash_attention": ["void flash_kernel<float, 64>(float const*, float "
                        "const*, float const*, float*, int, int, float)"],
    "smalls_attention": ["void smalls_kernel<__nv_bfloat16, 32>("
                         "__nv_bfloat16 const*, int, int, float)"],
    "group_norm": ["void group_norm_regs_kernel<float, true>(float const*)",
                   "void group_norm_cluster_kernel<__nv_bfloat16, false>()",
                   "void group_norm_stream_kernel<float, true>(int)"],
    "vq_argmin": ["vq_kernel(float const*, float const*, int*, int, int, "
                  "int, int)"],
    "conv3x3_norm_silu": ["void conv3x3_kernel<__nv_bfloat16, 4, true>("
                          "ConvParams)",
                          "void group_affine_kernel<__nv_bfloat16, true>("
                          "__nv_bfloat16 const*, float const*)"],
    "conv3x3": ["void conv3x3_kernel<float, 8, false>(ConvParams)"],
    "conv3x3 pack/reduce": ["void pack_weight_kernel<float>(float const*)",
                            "void splitk_reduce_kernel<__nv_bfloat16>()"],
}
LIBRARY = {
    "GEMM": [
        "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_"
        "warpgroupsize1x1x1_execute_segment_k_off_kernel__5x_cublas",
        "nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_NNT",
        "void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu_"
        "bf16_64x64_64x4_tn_align8>(Params)",
        "ampere_sgemm_128x64_nn",
        "void gemv2T_kernel_val<int, int, float, float, float, float, 128, "
        "16, 4, 4, false, false>(Params)",
        "aten::addmm", "aten::bmm", "aten::mm"],
    "cuDNN conv": [
        "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
        "tilesize128x128x64_warpgroupsize1x1x1_g1_execute_segment_k_off_"
        "kernel__5x_cudnn",
        "void fft2d_r2c_32x32<float, false, 1u, false>(float2*)",
        "void cudnn::engines_precompiled::nchwToNhwcKernel<float, float>()",
        "void implicit_convolve_sgemm<float, float, 128, 5, 5, 3, 3, 3, 1, "
        "false, false, true>(int)",
        "sm80_xmma_dgrad_implicit_gemm_indexed_f32f32_tf32f32_f32_nhwckrsc_"
        "nchw_tilesize64x32x64_stage5_warpsize2x2x1_g1_tensor16x8x8_kernel",
        "sm80_xmma_gemm_cf32cf32_f32f32_cf32_tn_n_tilesize32x32x8_stage3_"
        "warpsize2x2x1_ffma_aligna8",
        "aten::mkldnn_convolution", "aten::convolution_backward"],
    "elementwise": [
        "void at::native::vectorized_elementwise_kernel<4, at::native::"
        "silu_kernel(at::TensorIteratorBase&)::{lambda()#1}>(int)",
        "void at::native::distribution_elementwise_grid_stride_kernel<float,"
        " 4, at::native::normal_kernel>(long)",
        "void at::native::elementwise_kernel<128, 2, at::native::"
        "gpu_kernel_impl_nocast<at::native::CUDAFunctor_add<float> > >(int)",
        "aten::add", "aten::mul", "aten::silu"],
    "reduction/norm": [
        "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float,"
        " at::native::MeanOps<float, float, float, float>, unsigned int, "
        "float, 4> >(at::native::ReduceOp<float>)",
        "void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, "
        "float, float, float>(float*)",
        "void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel<"
        "float, float>(long)",
        "aten::native_group_norm", "aten::_softmax", "aten::sum"],
    "copy/cast": [
        "void at::native::vectorized_elementwise_kernel<4, at::native::"
        "direct_copy_kernel_cuda(at::TensorIteratorBase&)>(int)",
        "Memcpy HtoD (Pageable -> Device)", "Memset (Device)",
        "void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>"
        "()", "aten::copy_", "aten::_to_copy"],
}


@pytest.mark.parametrize("want", sorted(PORT) + sorted(LIBRARY))
def test_categorizer(want):
    for name in {**PORT, **LIBRARY}[want]:
        assert profile_step.categorize(name) == want, name
    assert set(profile_step.PORT_KERNEL_NAMES) < set(PORT)
    assert profile_step.categorize("void upsample_nearest2d_out_frame("
                                   "float*)") == "other"


def _event(name, us, shapes=""):
    return {"name": name, "us": us, "shapes": shapes}


def test_summarize_synthetic_events(capsys):
    flash, conv = PORT["flash_attention"][0], LIBRARY["cuDNN conv"][0]
    gemm, ew = LIBRARY["GEMM"][0], LIBRARY["elementwise"][0]
    events = [_event(flash, 300.0), _event(flash, 500.0),
              _event(conv, 400.0, "aten::cudnn_convolution [[4, 8]]"),
              _event(gemm, 600.0, "aten::mm [[2, 3], [3, 4]]"),
              _event(ew, 200.0)]
    out = profile_step.summarize(events, 2, "unit", top=3, wall=0.01)
    assert out["ms"] == pytest.approx(2000.0 / 2 / 1e3)
    assert out["wall_ms"] == pytest.approx(5.0)
    assert out["categories"] == pytest.approx(
        {"flash_attention": 0.4, "GEMM": 0.3, "cuDNN conv": 0.2,
         "elementwise": 0.1})
    assert list(out["categories"]) == ["flash_attention", "GEMM",
                                       "cuDNN conv", "elementwise"]
    assert sum(out["shares"].values()) == pytest.approx(100.0)
    assert out["shares"]["GEMM"] == pytest.approx(30.0)
    assert [(n, ms) for n, ms, _ in out["top"]] == [
        (flash, pytest.approx(0.4)), (gemm, pytest.approx(0.3)),
        (conv, pytest.approx(0.2))]
    assert out["top"][1][2] == "aten::mm [[2, 3], [3, 4]]"
    text = capsys.readouterr().out
    assert "== unit: 1.000 ms/call device time, 5.00 ms/call wall" in text
    # fp32 library kernels (CUDA cores) are not in the tensor-core table
    fp32 = [_event(LIBRARY["GEMM"][3], 100.0),
            _event(LIBRARY["cuDNN conv"][-3], 100.0)]
    cores = profile_step.tensor_core_by_shape(events + fp32, 2, 5)
    assert cores == pytest.approx({
        ("flash", "float, 64"): 0.4, ("gemm", "aten::mm [[2, 3], [3, 4]]"):
        0.3, ("conv", "aten::cudnn_convolution [[4, 8]]"): 0.2})


class _Range:
    def __init__(self, start, us):
        self.start, self._us = start, us

    def elapsed_us(self):
        return self._us


class _Event:
    """The fields of ``torch.autograd.profiler_util.FunctionEvent`` that
    ``device_events`` reads."""

    def __init__(self, name, device, start, us, kernels=(), shapes=()):
        from torch.autograd import DeviceType

        self.name, self.time_range = name, _Range(start, us)
        self.device_type = getattr(DeviceType, device)
        self.kernels = [type("K", (), {"name": k})() for k in kernels]
        self.input_shapes = list(shapes)
        self.self_cpu_time_total = us


def test_device_events_link_kernels_to_their_operators():
    gemm, ew = LIBRARY["GEMM"][0], LIBRARY["elementwise"][0]
    ops = [_Event("aten::mm", "CPU", 0, 5, [gemm], [[2, 3], [3, 4]]),
           _Event("aten::add", "CPU", 1, 5, [ew], [[8], [8]]),
           _Event("aten::mm", "CPU", 2, 5, [gemm], [[6, 3], [3, 4]]),
           _Event("unit", "CPU", 0, 9)]
    # the annotation's device-side range spans the kernels: left out
    kernels = [_Event("unit", "CUDA", 9, 20.0),
               _Event(gemm, "CUDA", 10, 7.0), _Event(ew, "CUDA", 11, 1.0),
               _Event(gemm, "CUDA", 12, 9.0),
               _Event(PORT["vq_argmin"][0], "CUDA", 13, 2.0)]
    prof = type("P", (), {"events": lambda self: ops + kernels[::-1]})()
    assert profile_step.device_events(prof) == [
        _event(gemm, 7.0, "aten::mm [[2, 3], [3, 4]]"),
        _event(ew, 1.0, "aten::add [[8], [8]]"),
        _event(gemm, 9.0, "aten::mm [[6, 3], [3, 4]]"),
        _event(PORT["vq_argmin"][0], 2.0, "")]
    cpu = type("P", (), {"events": lambda self: ops})()
    assert [e["name"] for e in profile_step.device_events(cpu)] == [
        "aten::mm", "aten::add", "aten::mm"]


def test_profile_train_shares_the_summary():
    assert profile_train.report is profile_step.report
    assert profile_train.capture is profile_step.capture


def test_profile_step_prints_every_unit(capsys, monkeypatch):
    res = profile_step.main(["--tiny", "--device", "cpu", "--batch", "1",
                             "--iters", "1", "--top", "3", "--units",
                             ",".join(profile_step.UNITS)])
    text = capsys.readouterr().out
    assert set(res) == set(profile_step.UNITS)
    for unit in profile_step.UNITS:
        assert f"== {unit}: " in text
        assert res[unit]["ms"] > 0 and res[unit]["wall_ms"] > 0
    assert "per-step (sequential CFG, both stages)" in text
    assert res["stage1"]["categories"]["GEMM"] > 0
    assert res["decode"]["categories"]["cuDNN conv"] > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profile_step.main(["--tiny"])


def test_profile_train_prints_every_unit(capsys, monkeypatch):
    res = profile_train.main(["--tiny", "--device", "cpu", "--batch", "1",
                              "--iters", "1", "--top", "3"])
    text = capsys.readouterr().out
    assert set(res) == set(profile_train.UNITS)
    for label in ("step (full)", "encode (frozen first stage)",
                  "lossgrad (cond + 2-stage UNet fwd+bwd)",
                  "opt (AdamW + EMA)"):
        assert f"== {label}: " in text
    assert "sub-units account for" in text and "device-time bound" in text
    res = profile_train.main(["--tiny", "--msvqgan", "--device", "cpu",
                              "--batch", "1", "--iters", "1", "--top", "3"])
    assert "== msvqgan GAN step (G+D): " in capsys.readouterr().out
    assert res["msvqgan"]["categories"]["cuDNN conv"] > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profile_train.main(["--tiny"])
