"""Device ms a traced request spends in the gl2 chain's second GEMM (the
program's "gl2.step" spans of index 1: Gl2Chain.matmul at level 1 on 10
limbs, its tensor and its relinearize over 13 QP limbs with the level's
own switch keys)."""

from fhebench.layers.gl2_chain_step0_ms import step_ms


def read(trace):
    return step_ms(trace, 1)
