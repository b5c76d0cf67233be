"""``python3 -m port_bench``: run one cell once (see ``run.py``)."""

import time

T_START = time.perf_counter()

if __name__ == "__main__":
    import sys

    from port_bench.run import main

    sys.exit(main(sys.argv[1:], t_start=T_START))
