"""Fixture: a kernel build whose nvcc flags lost their IEEE guarantees."""
NVCC_FLAGS = ("-O3", "-prec-div=true", "-ftz=false", "-fmad=false",
              "--use_fast_math")
