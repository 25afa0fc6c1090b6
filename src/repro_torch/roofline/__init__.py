from repro_torch.roofline.analysis import (HBM_BW, LINK_BW, PEAK_FLOPS,
                                           Roofline)
from repro_torch.roofline.op_count import OpAnalysis, analyze_program
