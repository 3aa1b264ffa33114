"""The benchmark's plain reference: frozen copies of the port's plain code
(the configuration's constants, the scene construction, the rollout kernels'
plain versions, the models, DDIM, the objectives and metrics) and a plain
guided sampler, in float32 with TF32 off. Nothing here imports the program
(``dgdm_tpu_torch``) or the JAX package: the reference makes every scene,
weight table and schedule again from the inputs the benchmark hands to both
sides.
"""
