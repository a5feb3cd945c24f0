"""Hardware models of the port: copies of ``repro/hwsim`` (stdlib and
numpy only), kept here so that the port imports nothing of the JAX
package.

memory        — off-chip DRAM access energy (Sec. VII-C, Fig. 14)
spartus_model — cycle-approximate Spartus latency/throughput model
"""
