from cokriging_tpu_torch.predict.iterative import IterativeJointPredictor  # noqa: F401
from cokriging_tpu_torch.predict.joint import JointPredictor  # noqa: F401
from cokriging_tpu_torch.predict.local import LocalPredictor  # noqa: F401
