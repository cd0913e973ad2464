from repro_torch.mapreduce.engine import (VOCAB, WORKLOAD_FNS, MRJob,
                                          make_blocks, run_mapreduce)
