"""Domain decomposition of the port: the device mesh and the decomposed
state (:mod:`.mesh`), the halo exchange (:mod:`.halo`) and the K-step loop
on the kernels' ext mode (:mod:`.kernel`)."""
