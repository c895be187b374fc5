# Frozen copy of respmon_tpu_torch/config.py:1-151 at commit 17374d4 (the benchmark's plain reference; imports rewritten to this package).
# Copied from respmon_tpu/config.py:1-164 (comments on accelerator-specific
# trade-offs reworded; names, fields, order and defaults unchanged).
"""Frozen, hashable configuration for the monitor pipeline.

Mirrors every hyperparameter of the reference monitor with identical defaults
(reference base.py:21-34 constructor kwargs + base.py:54-106 hardcoded
hyperparameters + base.py:548-551 ``locate`` defaults).  The dataclasses are
frozen, so one config instance can key caches and be shared between calls.
Field for field the classes of ``respmon_tpu/config.py``, so that a config
round-trips between the two packages (``interop.config_from_reference``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class FeatureParams:
    """Shi-Tomasi corner detection parameters (reference base.py:91-94)."""

    max_corners: int = 100
    quality_level: float = 0.3
    min_distance: float = 7.0
    block_size: int = 7


@dataclasses.dataclass(frozen=True)
class LKParams:
    """Pyramidal Lucas-Kanade parameters (reference base.py:96-98)."""

    win_size: Tuple[int, int] = (15, 15)
    max_level: int = 2
    max_iters: int = 10          # cv2.TERM_CRITERIA_COUNT, 10
    epsilon: float = 0.03        # cv2.TERM_CRITERIA_EPS, 0.03


@dataclasses.dataclass(frozen=True)
class CalibrationConfig:
    """EVM ROI localization parameters.

    Defaults follow reference base.py:80-85 (monitor-level) and
    base.py:548-551 (``locate`` signature defaults).
    """

    buffer_length: int = 128            # calibration_buffer_target_length
    freq_min: float = 0.1
    freq_max: float = 1.0
    amplification: float = 500.0
    pyramid_levels: int = 9
    skip_levels_at_top: int = 4
    temporal_threshold: float = 0.7     # suppress-top window proportion
    threshold: float = 0.08             # binary threshold (x255 at use site)
    maximum_bounding_box_area: float = math.inf
    # The reference's EVM accepts a pluggable temporal filter
    # (transforms.py:146 `temporal_filter_function`); 'fft' is the production
    # default, 'iir' the order-6 Butterworth alternative (as SOS for f32).
    temporal_filter: str = "fft"


@dataclasses.dataclass(frozen=True)
class MeasureConfig:
    """Measurement / BPM-estimation parameters (reference base.py:88-106)."""

    buffer_length: int = 128            # measure_buffer_length
    confidence_interval: float = 0.95
    gaussian_cutoff: float = 10.0
    filter_order: int = 3
    initialization_length: int = 12     # samples before BPM estimation starts
    peak_threshold: float = 0.3         # peakutils.indexes default `thres`
    max_peaks: int = 32                 # static cap on candidate peaks (masked)
    # Hybrid f64 refinement of WILD accepted gauss fits: the f32 LM's loose
    # ftol accepts huge extrapolated Gaussians (center many window-spans
    # outside, |ampl| >> data) on windows where scipy's f64 path exhausts
    # maxfev and the reference DROPS the peak; one such extra peak moves BPM
    # by several units.  Suspect lanes (accepted AND center > 2 spans outside
    # OR |ampl| > 5x data) are fitted again in f64 at MINPACK tolerances.
    f64_refine: bool = True


@dataclasses.dataclass(frozen=True)
class MonitorConfig:
    """Top-level monitor configuration.

    Constructor-kwarg tier of the reference (base.py:21-34) plus the nested
    hyperparameter groups.  ``validate()`` reproduces the reference's assert
    semantics.
    """

    fps_limit: float = 10.0
    error_reset_delay: float = 10.0
    save_all_data: bool = True
    save_calibration_image: bool = False
    visualize: Optional[str] = "pyqtgraph"
    fig_size: Optional[Tuple[int, int]] = None
    motion_extraction_method: str = "average"
    disable_error_detection: bool = False

    calibration: CalibrationConfig = CalibrationConfig()
    measure: MeasureConfig = MeasureConfig()
    features: FeatureParams = FeatureParams()
    lk: LKParams = LKParams()

    # Pipeline-level knobs (no reference analog).
    compute_dtype: str = "float32"      # device compute dtype
    roi_bucket: int = 32                # ROI dims rounded up to this multiple
                                        # (a few crop shapes, not one per ROI)
    # Streaming ROI mode: when enabled, the monitor keeps a rolling pyramid
    # ring during measurement and re-locks the ROI onto the localizer's
    # current bbox every ``streaming_interval`` frames once its center
    # drifts > ``streaming_drift_px``, so a moving subject is followed
    # continuously instead of degrading into the error-reset cycle.
    streaming_roi: bool = False
    streaming_interval: int = 8         # frames between streaming updates
    streaming_drift_px: float = 4.0     # min center drift to re-lock
    # Fleet BPM f64 refinement: whether a multi-stream fleet
    # (``parallel.streams.MultiStreamMonitor``) runs the wild-fit
    # refinement of ``MeasureConfig.f64_refine``; the single-stream monitor
    # and the whole-clip path always follow ``MeasureConfig.f64_refine``.
    # Off by default, as in the JAX package (one persistent suspect lane
    # makes every lockstep step pay the refit loop).
    fleet_f64_refine: bool = False
    # Fleet LK prev-window extraction: True forces the exact per-point
    # slice path in fleets.  The port has one LK path, the exact one, and
    # carries the field only for round-trips.
    fleet_exact_lk: bool = False

    def validate(self) -> "MonitorConfig":
        """Assert-based validation matching reference base.py:24-34."""
        assert isinstance(self.fps_limit, (int, float)) and self.fps_limit > 0, \
            "fps_limit must be a positive int or float"
        assert isinstance(self.save_calibration_image, bool), \
            "save_calibration_image must be bool"
        assert self.visualize == "pyqtgraph" or self.visualize is None, \
            "visualize must be 'pyqtgraph' or None"
        assert self.fig_size is None or (
            isinstance(self.fig_size, (tuple, list)) and len(self.fig_size) == 2
        ), "fig_size should be None or length 2 tuple or list"
        assert isinstance(self.error_reset_delay, (int, float)) and \
            self.error_reset_delay >= 0, \
            "error_reset_delay must be a positive int or float"
        assert isinstance(self.save_all_data, bool), "save_all_data should be bool"
        assert self.motion_extraction_method in ("average", "flow"), \
            "motion_extraction_method must be 'average' or 'flow'"
        return self

    def peak_minimum_sample_distance(self, fps: float) -> int:
        """FPS-dependent min peak distance (reference base.py:441)."""
        return int(math.floor(fps / self.calibration.freq_max))
