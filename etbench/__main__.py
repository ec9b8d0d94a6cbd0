import time

T0 = time.perf_counter()  # set-up is timed from here: before torch, numpy or the program load

import sys  # noqa: E402

from .run import main  # noqa: E402

sys.exit(main(sys.argv[1:], T0))
