"""Where LM training spends its time on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_train

Trains qwen3-0.6b at full width through ``make_train_step`` (random bf16
weights from a seed, ``TokenPipeline`` batches of B=4 x S=2048 tokens) and
traces one step with ``torch.profiler`` after a warm-up step. Prints one
JSON line: the step's wall time (host clock, ending in a synchronize), its
device-busy time (the sum of the kernels' times; the step runs on one
stream, so they do not overlap) and the device's idle share, the device
time of each kind of kernel (the backward flash kernels, wgmma and
3xTF32, the forward flash kernels, matrix products, the rest) and of each
flash kernel's entry function (the backward's passes apart), the
kernels with the most device time, the aten ops the step dispatches,
and the peak device memory. Needs a CUDA device.
"""
from __future__ import annotations

import json

import torch

from ..configs import ARCHS
from ..data.pipeline import PipelineConfig, TokenPipeline
from ..optim import adamw
from .profile_serve import _OpCount, _kernel_times, profile_phase
from .steps import make_train_step

B, S = 4, 2048
# kernel-name fragments of each kind, first match wins
KINDS = (("flash_attention_bwd_sm90", ("flash_attention_bwd_sm90",)),
         ("flash_attention_bwd", ("flash_attention_bwd",)),
         ("flash_attention_fwd", ("flash_attention",)),
         ("matmul", ("gemm", "cutlass", "xmma", "cublas", "nvjet")))


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def profile(cfg, device, B: int, S: int) -> dict:
    model, step, _, _ = make_train_step(cfg, device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    state = {"params": params, "opt": adamw.init(params)}
    pipe = TokenPipeline(PipelineConfig(cfg.vocab, S, B))

    def one(i):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in pipe.batch_at(i).items()}
        state["params"], state["opt"], _ = step(state["params"],
                                                state["opt"], batch)

    one(0)                                   # warm-up
    torch.cuda.reset_peak_memory_stats(device)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    out = {"arch": cfg.name, "B": B, "S": S,
           "step": profile_phase(device, lambda: one(1), top=12)}
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(device)
    with torch.profiler.profile(activities=acts) as prof:
        one(2)
        torch.cuda.synchronize(device)
    by_kind, flash = {}, {}
    for name, calls, us in _kernel_times(prof)[1]:
        k = kind_of(name)
        by_kind[k] = by_kind.get(k, 0.0) + us / 1e3
        if "flash_attention" in name:
            # "void (anonymous namespace)::<entry><DH>(...)" -> entry
            entry = name.split("::")[-1].split("<")[0]
            flash[entry] = {"calls": calls, "ms": us / 1e3}
    out["device_ms_by_kind"] = by_kind
    out["flash_kernels"] = flash
    with _OpCount() as count:
        one(3)
    out["aten_ops_per_step"] = count.n
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = profile(ARCHS["qwen3-0.6b"], torch.device("cuda"), B, S)
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
