"""The paper's Level-A studies on the port (the reference's
``benchmarks/`` scripts of the same names): Table III, the communication
reduction against SSP, the straggler and async-rounds study, the GUP
trace, the alpha/beta sensitivity and the BSP breakdown, and ``run``, their
CSV runner.  Each study takes ``device`` (the card unless the caller asks
for the CPU) and threads it into every ``run_framework`` call; what the
reference writes under ``results/`` goes under ``results/torch/``."""
