from .functional import kv_dequantize_arrays, kv_quantize_arrays

__all__ = ["kv_quantize_arrays", "kv_dequantize_arrays"]
