import sys
import time

T0 = time.perf_counter()  # set-up counts from here: the imports are part of it

from .run import main  # noqa: E402

sys.exit(main(t_start=T0))
