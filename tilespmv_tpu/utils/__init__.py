from .host import csr_transpose, exclusive_scan, binary_search_right_boundary

__all__ = ["exclusive_scan", "csr_transpose",
           "binary_search_right_boundary"]
