from trivy_tpu_torch.native.loader import gram_sieve_native, load_native

__all__ = ["gram_sieve_native", "load_native"]
