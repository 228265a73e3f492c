"""``chip_smoke.py``'s phases 5 and 6, then 15a, 15b and 16 (not 15c) on
every card the machine shows, one rank a card over NCCL: the mesh axes
at W = the card count, the tensor axis at T = W.  Every check is logged
rather than raised, so one call shows all of them; the ranks' results
and the failed checks go to ``chiprun_out/multi_card_checks.json``.

    python tools/multi_card_checks.py        # e.g. on four cards
    python tools/multi_card_checks.py --15b  # phases 6 and 15b only

The parent starts each rank as ``python tools/multi_card_checks.py
--rank DIR [--15b]`` under JAX's env triple.
"""
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

FAILED = []


def check(cond, msg):
    if not cond:
        FAILED.append(msg)
        cs.log(f"CHECK FAILED: {msg}")


cs.check = check


def rank_main(work, only_15b):
    cs._phase15c = lambda work, smi: {"launches": {}}
    if only_15b:
        from sdxl_training_improvements_tpu_torch.parallel import dryrun
        dryrun.dryrun_multichip = lambda *a, **kw: None
        cs._phase16 = lambda *a, **kw: {}
    try:
        cs._phase15_rank(work)
    finally:
        (Path(work) / f"failed{os.environ['SDXL_PROCESS_ID']}.json"
         ).write_text(json.dumps(FAILED))


def main(only_15b):
    t0 = time.perf_counter()
    smi = cs.phase_environment()
    cs.phase_build()
    from sdxl_training_improvements_tpu_torch.config import Config
    from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
    from sdxl_training_improvements_tpu_torch.models.unet import UNetConfig
    cfg = Config()
    model = SDXLModel.create(
        tiny=False, dtype=torch.bfloat16, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(cs.SEED),
        unet_config=UNetConfig.sdxl(remat=cfg.tpu.remat,
                                    remat_policy=cfg.tpu.remat_policy))
    record = {} if only_15b else {"latents": cs.phase_slice(model)["latents"]}
    cs.phase_train(model, cfg, record=record)
    del model
    cs._free()
    world = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        (work / "smi.txt").write_text(smi.splitlines()[0])
        torch.save(record, work / "phase6.pt")
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--rank", str(work)]
            + (["--15b"] if only_15b else []),
            env=dict(os.environ, COORDINATOR_ADDRESS=f"localhost:{port}",
                     SDXL_NUM_PROCESSES=str(world), SDXL_PROCESS_ID=str(r),
                     LOCAL_RANK=str(r))) for r in range(world)]
        codes = [p.wait(timeout=900) for p in procs]
        ranks = [json.loads((work / f"rank{r}.json").read_text())
                 for r in range(world) if (work / f"rank{r}.json").exists()]
        rank_failed = [json.loads((work / f"failed{r}.json").read_text())
                       for r in range(world)
                       if (work / f"failed{r}.json").exists()]
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "multi_card_checks.json").write_text(json.dumps(
        dict(codes=codes, ranks=ranks, failed=FAILED,
             rank_failed=rank_failed), default=str))
    cs.log(f"ranks exited {codes}; checks failed: parent {FAILED}, ranks "
           f"{rank_failed}; "
           f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(sys.argv[2], "--15b" in sys.argv[3:])
    else:
        main("--15b" in sys.argv[1:])
