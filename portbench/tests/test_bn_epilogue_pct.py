"""The reader of ``bn_epilogue_pct`` (``portbench/metrics/bn_epilogue_pct.py``)
on synthetic device traces: the ConvBN epilogue kernel's launches over
those launches plus cuDNN's and ATen's BatchNorm kernels', in %, other
kernels left out; nothing where the trace holds neither, or no kernels."""
import pytest

from portbench import run
from portbench.trace import Summary, Trace

NAMES = ("bn_epilogue_pct.infer", "bn_epilogue_pct.serve")
EPILOGUE = ("void convbn_epilogue_kernel<__nv_bfloat16, 8, true, true>("
            "__nv_bfloat16 const*, float const*, float const*, float const*,"
            " float const*, float const*, float*, unsigned int, unsigned int,"
            " unsigned int, unsigned int, float)")
CUDNN = ("void cudnn::bn_fw_inf_1C11_kernel_NCHW<float, float, true, 1>("
         "float, float, cudnnTensorStruct, float const*)")
ATEN = ("void at::native::batch_norm_transform_input_kernel<float, float, "
        "float, int>(...)")
OTHERS = ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
          "void at::native::vectorized_elementwise_kernel<4, "
          "at::native::CUDAFunctor_add<float>>(...)",
          "Memcpy HtoD (Pinned -> Device)")


def _res(names):
    kernels = [(n, 10.0 * i, 10.0 * i + 5) for i, n in enumerate(names)]
    return {"trace": Trace(kernels, [], 10.0 * len(names) + 5, 1)}


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("kernels,want", [
    ([EPILOGUE] * 4 + list(OTHERS), 100.0),
    ([CUDNN] * 3 + list(OTHERS), 0.0),
    ([EPILOGUE] * 3 + [CUDNN] + list(OTHERS), 75.0),
    ([EPILOGUE, ATEN, CUDNN, EPILOGUE], 50.0)])
def test_the_share_of_batchnorms_in_the_epilogue(name, kernels, want):
    assert run.metric_reader(name)(_res(kernels)) == pytest.approx(want)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_without_batchnorms(name):
    assert run.metric_reader(name)(_res(list(OTHERS))) is None
    assert run.metric_reader(name)({"trace": None}) is None


@pytest.mark.parametrize("name", NAMES)
def test_nothing_from_a_summary_without_kernels(name):
    summary = Summary({"busy_us": 1.0, "wall_us": 2.0, "units": 1,
                       "launches": 3, "breakdown": {}, "busy_of": {}})
    assert run.metric_reader(name)({"trace": summary}) is None
