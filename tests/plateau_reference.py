"""The plateau's numpy reference, which imports neither JAX nor torch.

``optax.contrib.reduce_on_plateau`` (cooldown 0, min_scale 0) made blind
to non-finite values, as ``tpu3dssf.train.state._finite_value_plateau``,
folded on the host in float32: a NaN/Inf value leaves the state untouched,
so an epoch's decision sees exactly its finite values. The port keeps this
state on the device (``tpu3dssf_torch.train.state.DevicePlateau``);
tests/test_torch_train.py and chip_smoke.py hold that bit for bit against
this class.
"""

import numpy as np


class Plateau:

    def __init__(self, factor=0.1, patience=10, rtol=1e-4, atol=0.0,
                 accumulation_size=1):
        self.factor, self.patience = factor, patience
        self.rtol, self.atol = rtol, atol
        self.accumulation_size = accumulation_size
        self.scale = np.float32(1.0)
        self.best_value = np.float32(np.inf)
        self.plateau_count = 0
        self.count = 0
        self.avg_value = np.float32(0.0)

    def update(self, value) -> float:
        """Fold one per-batch value in; returns the scale of this update."""
        value = np.float32(value)
        if not np.isfinite(value):
            return float(self.scale)
        new_count = self.count + 1
        self.avg_value = ((np.float32(self.count) * self.avg_value + value)
                          / np.float32(new_count))
        self.count = new_count
        if new_count == self.accumulation_size:
            improved = self.avg_value < (
                (np.float32(1.0) - np.float32(self.rtol)) * self.best_value
                - np.float32(self.atol))
            if improved:
                self.best_value = self.avg_value
            count = 0 if improved else self.plateau_count + 1
            if count == self.patience:
                self.scale = np.float32(self.scale * np.float32(self.factor))
                count = 0
            self.plateau_count = count
            self.count, self.avg_value = 0, np.float32(0.0)
        return float(self.scale)

    def values(self):
        """The state as (scale, best_value, plateau_count, count,
        avg_value), the f32 ones as np.float32."""
        return (self.scale, self.best_value, self.plateau_count, self.count,
                self.avg_value)
