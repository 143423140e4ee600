// The converter model (DAC/ADC) shared by the kernels of this directory.
//
// Follows core/quantization.py exactly: clip to [-fs, fs], divide by `step`
// (IEEE division: no reciprocal, no fast math), rintf (round half to even,
// like torch.round / jnp.round), multiply by `step`.  bits <= 0 is an ideal
// converter.  The step is computed once on the host in double, as the
// reference's Python arithmetic does, and passed in as a float.
#pragma once

__device__ __forceinline__ float quantize(float v, int bits, float step,
                                          float fs) {
  if (bits <= 0) return v;
  v = v < -fs ? -fs : (v > fs ? fs : v);  // propagates NaN like clamp
  return rintf(v / step) * step;
}
