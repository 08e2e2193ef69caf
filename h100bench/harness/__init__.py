"""The H100 benchmark's yardstick: cell resolution, device checks, traffic
generation, the profiler's reduction, roofline arithmetic and the
comparisons that decide ``correct``. Nothing here imports JAX or the JAX
package; the port (``endoscopydepthestimation_pytorch_tpu_torch``) is
imported only by the drivers, as the system under test."""
