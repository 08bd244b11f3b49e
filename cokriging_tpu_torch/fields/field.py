"""Field / MultiField containers.

Counterpart of ``cokriging_tpu/fields/field.py`` for array-built fields:
``Field.from_arrays``, ``Field.astype`` and ``MultiField``. Members are torch
tensors on the host; the entry points move them to their device.
``Field.from_dataframe`` (the trend-removal pipeline over pandas frames)
comes with the data readers.
"""

from dataclasses import dataclass, replace
from typing import List, Optional

import numpy as np
import torch


@dataclass
class Field:
    """One process at one timestamp: values + coordinates.

    ``coords``/``values`` live on the full grid, ``coords_main``/
    ``values_main`` on the base grid used for covariance assembly
    (src/fields.py:74-95). Coordinates are [lat, lon] rows for geodesic
    fields, [x, y] otherwise.
    """

    name: str
    timestamp: Optional[str]
    coords: torch.Tensor  # (n, 2)
    values: torch.Tensor  # (n,)
    coords_main: torch.Tensor  # (m, 2)
    values_main: torch.Tensor  # (m,)
    measurement_var: Optional[torch.Tensor] = None
    geodesic: bool = True

    @property
    def size(self) -> int:
        return int(self.values.shape[0])

    @classmethod
    def from_arrays(cls, coords, values, name: str = "Z") -> "Field":
        """Simulated-field constructor (src/fields.py:90-94): raw values,
        Euclidean [x, y] coordinates, main == full. Float dtypes are kept."""
        c = np.asarray(coords)
        v = np.asarray(values)
        c = torch.as_tensor(c if c.dtype.kind == "f" else c.astype(float))
        v = torch.as_tensor(v if v.dtype.kind == "f" else v.astype(float))
        return cls(
            name=name,
            timestamp=None,
            coords=c,
            values=v,
            coords_main=c,
            values_main=v,
            geodesic=False,
        )

    def astype(self, dtype) -> "Field":
        """Cast the tensor members to ``dtype``."""
        mv = self.measurement_var
        return replace(
            self,
            coords=self.coords.to(dtype),
            values=self.values.to(dtype),
            coords_main=self.coords_main.to(dtype),
            values_main=self.values_main.to(dtype),
            measurement_var=None if mv is None else mv.to(dtype),
        )


@dataclass
class MultiField:
    """p fields with per-process month offsets (src/fields.py:124-176)."""

    fields: List[Field]
    timestamp: Optional[str] = None
    timedeltas: Optional[List[int]] = None

    @property
    def n_procs(self) -> int:
        return len(self.fields)

    @property
    def n_data(self) -> int:
        return sum(f.size for f in self.fields)

    @property
    def geodesic(self) -> bool:
        return self.fields[0].geodesic

    def astype(self, dtype) -> "MultiField":
        return MultiField(
            fields=[f.astype(dtype) for f in self.fields],
            timestamp=self.timestamp,
            timedeltas=self.timedeltas,
        )
