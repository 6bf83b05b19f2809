"""``python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``:
one run of one cell (``harness.py``). Set-up is timed from here, before
PyTorch is imported."""
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    from portbench.harness import main

    raise SystemExit(main(t_start=T_START))
