from repro_torch.elastic.fleet import (FleetJob, FleetScheduler, ChipPool,
                                       EstimatorBridge)
