"""One run of one benchmark cell::

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for.
Prints one JSON line last on standard output, and the output check's
numbers beside their limits last on standard error.
"""

import time

T_PROCESS = time.time()  # before the heavy imports: set-up starts here

import sys  # noqa: E402

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_process=T_PROCESS))
