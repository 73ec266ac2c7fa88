from .harness import BenchResult, append_results_csv, benchmark_op
from .roofline import PEAKS, peak_for
from .sweep import sweep

__all__ = ["BenchResult", "benchmark_op", "append_results_csv", "sweep",
           "PEAKS", "peak_for"]
