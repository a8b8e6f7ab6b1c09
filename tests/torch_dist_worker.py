"""One worker process of ``tests/torch_dist.Ranks``.

    python tests/torch_dist_worker.py FUNC RANK WORLD PORT OUTDIR ARGS TIMEOUT INIT

Joins (INIT=1) a gloo process group of WORLD ranks at 127.0.0.1:PORT
(every collective under a timeout of TIMEOUT seconds; with INIT=0 the
function joins it, PORT in the environment as TEST_DIST_PORT), calls
``torch_dist_cases.FUNC(RANK, WORLD, *ARGS)`` and pickles ``(True,
value)`` or ``(False, traceback)`` to OUTDIR/rankRANK.pkl.  Imports no
JAX.
"""

import datetime
import faulthandler
import os
import pickle
import sys
import traceback


def main(func, rank, world, port, out, arg, timeout, init):
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [os.path.dirname(here), here]
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    # a hung collective shows where each rank waits
    faulthandler.dump_traceback_later(0.9 * timeout, exit=False)
    try:
        os.environ["TEST_DIST_PORT"] = port
        if init:
            dist.init_process_group(
                "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                world_size=world, timeout=datetime.timedelta(seconds=timeout))
        import torch_dist_cases

        args = pickle.loads(bytes.fromhex(arg))
        result = (True, getattr(torch_dist_cases, func)(rank, world, *args))
        if "jax" in sys.modules:
            raise AssertionError("a worker imported jax")
    except BaseException:  # noqa: BLE001 - the test reports it
        result = (False, traceback.format_exc())
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    if result[0] and dist.is_initialized():
        dist.destroy_process_group()
    # a failed rank leaves the others blocked in a collective: exit now,
    # the test kills them
    os._exit(0 if result[0] else 1)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5], sys.argv[6], int(sys.argv[7]), sys.argv[8] == "1")
