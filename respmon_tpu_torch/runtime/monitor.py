"""The RespiratoryMonitor: calibrate → measure → error → recalibrate.

Port of ``respmon_tpu/runtime/monitor.py``: a host state machine driving
the port's device pipeline, preserving the observable behavior of the
reference monitor (base.py:20-545):

  - constructor kwargs and assert validation (base.py:21-34),
  - per-frame loop: capture → state dispatch → UI update → fps sync
    (base.py:409-513), including the retry-on-no-contour calibration path,
    the dropped frame on the locate iteration, NaN error detection, the
    10 s error-reset delay, and reset semantics (base.py:515-533),
  - fps probing/limiting (base.py:303-310) and wall-clock sync
    (base.py:535-541),
  - ``skip_calibration`` ROI pinning (base.py:166-172),
  - session recording (AVI + npy) and the calibration montage PNG,
  - Benchmarker phase tags (base.py:410-412),

and the JAX package's streaming-ROI mode (``streaming_roi=True``): rolling
pyramid rings that absorb every measured frame (and every frame of the
error wait), a localize every ``streaming_interval`` frames that re-locks
the measurement window onto a drifting subject, and a warm recovery that
localizes from the rings instead of refilling the calibration buffer.

Departures from the reference (deliberate, documented):
  - Construction does NOT block: pass ``auto_run=True`` (the default mirrors
    the reference's ctor-runs behavior) or call ``run()`` explicitly;
    ``step()`` exposes single-frame stepping for tests and embedding.
  - The device work of a frame is ``locate`` once per calibration, and per
    measured frame the motion step, plus the BPM estimate once its result
    is consumed (after ``initialization_length`` samples); each frame's
    results, a streaming localize's bbox among them, cross to the host in
    one copy.  The whole-clip path lives in ``pipeline/scan.py``.
  - A capture source can be injected (ArrayCapture) for recorded-clip
    replay, and ``sync_fps=False`` disables wall-clock sleeping for
    faster-than-real-time offline runs.

All device state lives on ``device``, resolved once at construction:
``None`` means the card (``device.resolve``: it raises without one), and a
CPU run passes ``device="cpu"``.
"""

from __future__ import annotations

import logging
import math
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from respmon_tpu_torch import device as device_mod
from respmon_tpu_torch.config import MonitorConfig
from respmon_tpu_torch.io.capture import (CaptureSource, OpenCVCapture,
                                          open_capture)
from respmon_tpu_torch.io.recorder import SessionRecorder
from respmon_tpu_torch.ops import dtype as dtype_ops
from respmon_tpu_torch.ops import filters
from respmon_tpu_torch.pipeline import bpm as bpm_mod
from respmon_tpu_torch.pipeline import evm, motion, streaming
from respmon_tpu_torch.runtime.feeder import FrameFeeder
from respmon_tpu_torch.utils.bbox import reduce_bounding_box
from respmon_tpu_torch.utils.bench import Benchmarker, span
from respmon_tpu_torch.viz.ui import make_ui, overlay_keypoints

logger = logging.getLogger(__name__)


def _measure_and_estimate(state, frame, spec, coeffs, min_dist, cfg):
    """One live-path frame: the motion step, then the BPM estimate of the
    new signal ring (one unbatched window)."""
    with span("monitor.motion"):
        new_state, sample = motion.measure_step(state, frame, spec)
    with span("monitor.estimate"):
        res = bpm_mod.estimate_bpm(new_state.data, new_state.t,
                                   new_state.count, coeffs, min_dist, cfg)
    return new_state, sample, res


def _to_host(*tensors):
    """Copy small tensors to the host in one transfer: numpy arrays of
    their own dtypes and shapes.  They travel as float64, which holds
    float32, float64, bool and the small integers here exactly."""
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    flat = flat.cpu().numpy()
    out, i = [], 0
    for t in tensors:
        n = t.numel()
        dt = np.dtype(str(t.dtype).removeprefix("torch."))
        out.append(flat[i:i + n].reshape(tuple(t.shape)).astype(dt))
        i += n
    return out


def _bbox_to_host(res):
    """(found, x, y, w, h) of a locate result as Python ints, in one
    device-to-host copy."""
    return tuple(int(v) for v in _to_host(res.found, res.x, res.y, res.w,
                                          res.h))


class RespiratoryMonitor:
    def __init__(self, capture_target=0, save_calibration_image=False,
                 visualize: Optional[str] = "pyqtgraph", fig_size=None,
                 fps_limit=10, error_reset_delay=10.0, save_all_data=True,
                 motion_extraction_method="average",
                 config: Optional[MonitorConfig] = None,
                 capture: Optional[CaptureSource] = None,
                 auto_run: bool = True, sync_fps: bool = True,
                 compute_dtype=torch.float32,
                 use_feeder: Optional[bool] = None,
                 feeder_capacity: int = 4,
                 feeder_latest: Optional[bool] = None,
                 verbose_evm: bool = False,
                 streaming_roi: Optional[bool] = None,
                 native_uint8: bool = False,
                 device=None):
        cfg = config or MonitorConfig()
        cfg = MonitorConfig(
            fps_limit=fps_limit, error_reset_delay=error_reset_delay,
            save_all_data=save_all_data,
            save_calibration_image=save_calibration_image,
            visualize=visualize, fig_size=fig_size,
            motion_extraction_method=motion_extraction_method,
            disable_error_detection=cfg.disable_error_detection,
            calibration=cfg.calibration, measure=cfg.measure,
            features=cfg.features, lk=cfg.lk,
            compute_dtype=cfg.compute_dtype, roi_bucket=cfg.roi_bucket,
            streaming_roi=(cfg.streaming_roi if streaming_roi is None
                           else bool(streaming_roi)),
            streaming_interval=cfg.streaming_interval,
            streaming_drift_px=cfg.streaming_drift_px)
        self.config = cfg.validate()
        self.device = device_mod.resolve(device)
        self.benchmarker = Benchmarker()
        for tag in ("Measurement Loop", "Frame Capture",
                    "Calibration Measurement"):
            self.benchmarker.add_tag(tag)
        self.sync_fps_enabled = sync_fps
        self.compute_dtype = compute_dtype
        # Per-stage EVM timing logs during calibration (the reference's
        # transforms.py verbose=True path).
        self.verbose_evm = bool(verbose_evm)

        # Capture (probe fps/size like base.py:46-51).
        self.capture_target = capture_target
        self.cap = capture if capture is not None \
            else open_capture(capture_target, native_uint8=native_uint8)
        self.fps = self.cap.fps
        self.width = self.cap.width
        self.height = self.cap.height
        # Camera-native uint8 ingest: when the capture yields uint8 gray
        # frames, everything stays bytes host-side (4x less ring memory and
        # upload) and widens ON DEVICE via the bit-exact
        # ops/dtype.uint8_to_float — results are bit-identical to float
        # ingest.
        self.ingest_uint8 = np.dtype(getattr(
            self.cap, "frame_dtype", np.float32)) == np.uint8

        # Double-buffered host→device feed: a capture thread decodes into
        # the native SPSC ring so the blocking read the reference pays
        # every frame (base.py:416-421) overlaps the device step.  Default
        # ON for OpenCV sources (live path); injected array captures keep
        # direct synchronous replay for deterministic tests.
        if use_feeder is None:
            use_feeder = isinstance(self.cap, OpenCVCapture)
        self.use_feeder = bool(use_feeder)
        self.feeder_capacity = int(feeder_capacity)
        if feeder_latest is None:
            # Live sources (webcam indices, streaming-protocol URLs) want
            # the freshest frame — lossless backpressure against a live
            # source would make delivered frames lag real time without
            # bound.  File paths and downloadable URLs (http/file) replay
            # losslessly (FIFO) so accounting matches offline; pass
            # feeder_latest explicitly for live HTTP (e.g. MJPEG) feeds.
            live_schemes = ("rtsp://", "rtmp://", "udp://", "tcp://")
            feeder_latest = isinstance(capture_target, int) or (
                isinstance(capture_target, str)
                and capture_target.lower().startswith(live_schemes))
        self.feeder_latest = bool(feeder_latest)
        if (self.use_feeder and not self.feeder_latest
                and isinstance(capture_target, str)
                and capture_target.lower().startswith(("http://",
                                                       "https://"))):
            logger.warning(
                "http(s) source with a lossless (backpressure) feeder: a "
                "LIVE http stream (e.g. MJPEG) will lag real time without "
                "bound — pass feeder_latest=True for live HTTP feeds; "
                "downloadable clips replay losslessly as intended.")
        self._feeder = None
        self.frames_dropped = 0

        cal = cfg.calibration
        self.calibration_buffer_target_length = cal.buffer_length
        self.calibration_buffer = np.zeros(
            (cal.buffer_length, self.height, self.width),
            dtype=np.uint8 if self.ingest_uint8 else np.float32)
        self.calibration_buffer_idx = 0

        # Observable buffers mirroring the reference's deques
        # (base.py:121-133).
        self.all_data = []
        self.data = deque()
        self.t = deque()
        self.freq = deque()
        self.confidence = deque()
        self.num_peaks = deque()
        self.num_peaks_mean = deque()
        self.motion_data = deque()
        self.filtered_data = []
        self.peak_indices = []
        self.peak_times = []
        self.buffers = [self.data, self.confidence, self.t, self.freq,
                        self.num_peaks, self.num_peaks_mean, self.motion_data]

        self.x = self.y = self.w = self.h = None
        self.peak_minimum_sample_distance = 0
        self.disable_error_detection = cfg.disable_error_detection
        self.error_message = None
        self.current_frame = None
        self.cropped_image = None
        self.display_frame = None
        self.motion_key_points = None

        self.state = "initialize"
        self.calibration_start_time = math.nan
        self.loop_start_time = math.nan
        self.reset_start_time = math.nan
        self.frames_processed = 0

        self._recorder: Optional[SessionRecorder] = None
        self._measure_spec: Optional[motion.MeasureSpec] = None
        self._measure_state: Optional[motion.MeasureState] = None
        self._lowpass = None
        # Streaming-ROI mode (config.streaming_roi): rolling pyramid rings
        # + continuous re-lock during measurement.  ``_streaming_count``
        # mirrors the rings' device count on the host.
        self._streaming_state: Optional[streaming.StreamingState] = None
        self._streaming_tick = 0
        self._streaming_count = 0
        self.relocks = 0             # observable: streaming re-lock count
        # Frames the rings absorbed, by the state the monitor was in, and
        # the rings' warm starts from a calibration buffer.
        self.streaming_absorbed = {"calibration": 0, "measure": 0,
                                   "error": 0}
        self.streaming_starts = 0

        self.ui = make_ui(visualize, fig_size)

        if auto_run:
            self.run()

    # ------------------------------------------------------------------
    # Public control surface
    # ------------------------------------------------------------------

    def skip_calibration(self, x, y, w, h):
        """Pin a known ROI and jump straight to measurement
        (reference base.py:166-172)."""
        self.x, self.y, self.w, self.h = x, y, w, h
        self.peak_minimum_sample_distance = int(
            np.floor(self.fps / self.config.calibration.freq_max))
        self._setup_measurement()
        self.state = "measure"

    def run(self):
        """Process frames until the stream ends (reference base.py:409-513)."""
        while self.cap.is_open():
            if not self.step():
                break
        logger.info("Capture closed.")
        if self.freq:
            logger.info("Final BPM estimate: {0:.2f}".format(self.freq[-1]))
        self.stop_feeder()
        self.cap.release()
        if self.config.save_all_data and self._recorder is not None:
            self._recorder.all_data = self.all_data
            self._recorder.finalize()

    def step(self) -> bool:
        """One loop iteration.  Returns False at end of stream."""
        with span("monitor.step"):
            self.loop_start_time = time.time()

            self.benchmarker.tick_start("Frame Capture")
            with span("monitor.capture"):
                frame = self._next_frame()
            if frame is None:
                return False
            self.current_frame = frame
            self.benchmarker.tick_end("Frame Capture")

            skip_ui_and_sync = False
            if self.state == "initialize":
                self._initialize()
                self.state = "calibration"
            elif self.state == "calibration":
                skip_ui_and_sync = self._calibration_step(frame)
            elif self.state == "measure":
                with span("monitor.measure"):
                    self._measure_frame(frame)
            elif self.state == "error":
                # Streaming-ROI mode keeps the rings warm through the error
                # wait (the frames are captured anyway), so recovery can
                # localize from them (see _calibration_step's warm path).
                if (self.config.streaming_roi
                        and self._streaming_state is not None):
                    self._streaming_absorb(self._ingest(frame), "error")
                if time.time() - self.reset_start_time >= \
                        self.config.error_reset_delay:
                    logger.info("Benchmark Report...\r\n"
                                + self.benchmarker.get_report())
                    self.reset()
                    self.state = "calibration"

            if not skip_ui_and_sync:
                self.update_ui()
                self.sync_to_fps()
            self.frames_processed += 1
            return True

    def _next_frame(self):
        """Pull the next frame: directly from the capture, or — on the live
        path — from the double-buffered feeder ring so decode overlaps the
        device step.  Surfaces the cumulative dropped-frame count."""
        if not self.use_feeder:
            return self.cap.next_frame()
        if self._feeder is None:
            # Webcams self-pace (blocking read at camera rate) and keep
            # drop-oldest live semantics; file/array replay prefetches
            # losslessly — the decode thread blocks when the ring is full,
            # so every frame is delivered in order (reference accounting)
            # while decoding still overlaps the device step.
            self._feeder = FrameFeeder(
                self.cap, capacity=self.feeder_capacity,
                lossless=not self.feeder_latest,
                dtype=np.uint8 if self.ingest_uint8
                else np.float32).start()
        frame, _seq = self._feeder.next_frame(latest=self.feeder_latest)
        dropped = self._feeder.dropped
        if dropped > self.frames_dropped:
            logger.warning("Feeder dropped %d frame(s) total "
                           "(slow consumer).", dropped)
        self.frames_dropped = dropped
        return frame

    def stop_feeder(self):
        if self._feeder is not None:
            self.frames_dropped = self._feeder.dropped
            self._feeder.stop()
            self._feeder = None

    def trigger_error(self, msg=""):
        self.state = "error"
        self.error_message = msg
        logger.warning("Error triggered: {0}".format(msg))
        self.reset_start_time = time.time()

    def reset(self):
        """Clear all buffers and restart calibration (base.py:515-533)."""
        with span("monitor.reset"):
            self.state = "initialize"
            for b in self.buffers:
                b.clear()
            self.ui.clear_plots()
            self.filtered_data = []
            self.peak_indices = []
            self.peak_times = []
            self.calibration_buffer_idx = 0
            self._measure_state = None
            self.cropped_image = None
            self.motion_key_points = None
            # Streaming-ROI mode: the rings SURVIVE the reset (kept
            # fps-contiguous through the error wait) so the next calibration
            # can localize from them at once; otherwise the reference's cold
            # reset applies.
            if not self.config.streaming_roi:
                self._streaming_state = None
                self._streaming_tick = 0
                self._streaming_count = 0
            if self._recorder is not None:
                self._recorder.release_video()

    def detect_errors(self) -> bool:
        """True when the newest motion sample signals lost tracking.  The
        reference identity-checks the np.nan singleton (base.py:543-545),
        which only the flow path produces; semantically: flow-mode NaN."""
        if not self.data:
            return False
        return (self.config.motion_extraction_method == "flow"
                and isinstance(self.data[-1], float)
                and math.isnan(self.data[-1]))

    def sync_to_fps(self):
        if not self.sync_fps_enabled:
            return
        fps_x = self.fps
        if math.isnan(fps_x):
            fps_x = self.config.fps_limit
        sleep_time = (1.0 / fps_x) - (time.time() - self.loop_start_time)
        if sleep_time > 0:
            time.sleep(sleep_time)

    # ------------------------------------------------------------------
    # State handlers
    # ------------------------------------------------------------------

    def _initialize(self):
        self.calibration_start_time = time.time()
        self.calibration_buffer_idx = 0

    def detect_fps(self):
        """Empirical fps measurement + limiting (base.py:303-310)."""
        if self.fps == 0 or math.isnan(self.fps):
            self.fps = self.calibration_buffer_target_length / \
                (time.time() - self.calibration_start_time)
            logger.info("Computed FPS as {0}.".format(self.fps))
        if self.fps > self.config.fps_limit:
            logger.info("FPS Limited to {0}.".format(self.config.fps_limit))
            self.fps = self.config.fps_limit
        logger.info("Final FPS is {0}.".format(self.fps))

    def _ingest(self, frames) -> torch.Tensor:
        return dtype_ops.ingest_frames(frames, self.compute_dtype,
                                       self.device)

    def _calibration_step(self, frame) -> bool:
        """Returns True when UI/sync should be skipped (retry path)."""
        if self._warm_calibration_available():
            return self._warm_calibration_step(frame)
        if self.calibration_buffer_idx < self.calibration_buffer_target_length:
            with span("monitor.buffer"):
                self.calibration_buffer[self.calibration_buffer_idx] = frame
            self.calibration_buffer_idx += 1
            return False

        logger.info("Finished capturing calibration frames. "
                    "Beginning calibration...")
        self.detect_fps()
        self.peak_minimum_sample_distance = int(
            np.floor(self.fps / self.config.calibration.freq_max))

        self.benchmarker.tick_start("Calibration Measurement")
        locate_fn = evm.locate_verbose if self.verbose_evm else evm.locate
        with span("monitor.calibrate"):
            buffer_dev = self._ingest(self.calibration_buffer)
            result = locate_fn(buffer_dev, float(self.fps),
                               self.config.calibration)
            # The host read waits for the device, so the tag times
            # execution.
            found, x, y, w, h = _bbox_to_host(result)
        self.benchmarker.tick_end("Calibration Measurement")

        if not found:
            logger.info("Failed finding ROI during calibration. Retrying...")
            self.calibration_buffer_idx = 0
            return True  # reference `continue`s past UI/sync (base.py:454)

        self.x, self.y, self.w, self.h = reduce_bounding_box(
            x, y, w, h, self.config.calibration.maximum_bounding_box_area)

        if self.config.save_calibration_image:
            self._save_calibration_image(result)

        logger.info("Finished calibration.")
        logger.info("Beginning measuring...")
        self._setup_measurement()
        if self.config.streaming_roi:
            # Warm-start the rings from the calibration buffer (one K1
            # call) so re-locking can begin at once.
            self._streaming_state = streaming.init_streaming_from_buffer(
                buffer_dev, self.config.calibration)
            self._streaming_tick = 0
            self._streaming_count = self.config.calibration.buffer_length
            self.streaming_starts += 1
        self.state = "measure"
        return False

    def _warm_calibration_available(self) -> bool:
        """True when the streaming rings hold a full fps-contiguous window
        (kept warm through the error state), so calibration can localize
        at once instead of refilling the calibration buffer: the recovery
        dead time drops from ``buffer_length/fps`` seconds of fresh
        capture to one frame (reference base.py:515-533 can only
        cold-restart)."""
        if not self.config.streaming_roi or self._streaming_state is None:
            return False
        if math.isnan(self.fps) or self.fps <= 0:
            return False   # fps never probed: cold calibration measures it
        return self._streaming_count >= \
            self.config.calibration.buffer_length

    def _warm_calibration_step(self, frame) -> bool:
        """One warm-recovery calibration step: absorb the frame, localize
        over the rolling window, and enter measurement on success.  Returns
        True (skip UI/sync, like the cold retry path) while no ROI is
        found: each later frame retries, at frame rate instead of after
        another full buffer."""
        self.detect_fps()
        self.peak_minimum_sample_distance = int(
            np.floor(self.fps / self.config.calibration.freq_max))

        self.benchmarker.tick_start("Calibration Measurement")
        res = self._streaming_absorb(self._ingest(frame), "calibration",
                                     localize=True)
        found, x, y, w, h = _bbox_to_host(res)
        self.benchmarker.tick_end("Calibration Measurement")

        if not found:
            logger.info("Failed finding ROI during calibration. Retrying...")
            return True   # reference `continue`s past UI/sync (base.py:454)

        self.x, self.y, self.w, self.h = reduce_bounding_box(
            x, y, w, h, self.config.calibration.maximum_bounding_box_area)
        if self.config.save_calibration_image:
            logger.info("Calibration montage unavailable on the warm "
                        "(streaming-ring) recovery path; skipping save.")
        logger.info("Finished calibration (warm, from streaming rings).")
        logger.info("Beginning measuring...")
        self._setup_measurement()
        self._streaming_tick = 0
        self.state = "measure"
        return False

    def _streaming_absorb(self, frame_dev, state: str,
                          localize: bool = False):
        """Absorb a device frame into the rings (``state`` names the
        monitor state, for ``streaming_absorbed``); with ``localize``, also
        localize over the window and return the ``StreamingLocate``."""
        cal = self.config.calibration
        if localize:
            self._streaming_state, res = streaming.streaming_update(
                self._streaming_state, frame_dev, float(self.fps), cal)
        else:
            self._streaming_state = streaming.streaming_absorb(
                self._streaming_state, frame_dev, cal)
            res = None
        self._streaming_count = min(self._streaming_count + 1,
                                    cal.buffer_length)
        self.streaming_absorbed[state] += 1
        return res

    def _setup_measurement(self):
        # Crop-bucket reuse across recalibrations: when a fresh ROI fits
        # the previous bucket, the previous spec serves it (the same
        # object), so the crop shapes of every recovery cycle stay fixed.
        # A bucket more than 4x the needed area rebuilds anyway (a tiny ROI
        # inside a huge stale window would waste per-frame compute
        # forever).
        spec = self._measure_spec
        if (spec is not None and spec.fps == float(self.fps)
                and self.w <= spec.crop_w and self.h <= spec.crop_h
                and spec.crop_w * spec.crop_h
                <= 4 * max(self.w * self.h, 1)):
            logger.info("Reusing measurement crop bucket %dx%d for ROI "
                        "%dx%d.", spec.crop_w, spec.crop_h, self.w, self.h)
        else:
            self._measure_spec = motion.MeasureSpec.for_roi(
                self.config, self.height, self.width, self.w, self.h,
                float(self.fps))
        self._measure_state = motion.init_state(
            self._measure_spec, (self.x, self.y, self.w, self.h),
            dtype=self.compute_dtype, device=self.device)
        self._lowpass = filters.design_butter_lowpass(
            self.config.calibration.freq_max * 0.5, float(self.fps),
            self.config.measure.filter_order)

    def _measure_frame(self, frame):
        if self.config.save_all_data and self._recorder is None:
            self._recorder = SessionRecorder(self.capture_target, self.fps,
                                             (self.w, self.h))
        self.benchmarker.tick_start("Measurement Loop")
        spec = self._measure_spec
        flow = self.config.motion_extraction_method == "flow"

        for b in self.buffers:
            if len(b) >= self.config.measure.buffer_length:
                b.popleft()

        # The BPM estimate is consumed only once the ring holds more than
        # initialization_length samples (base.py:489); before that it is
        # not computed.  Past that length the "no key points" trigger
        # below, which needs a ring of one sample, cannot fire.
        init_len = self.config.measure.initialization_length
        consume = len(self.data) + 1 > init_len
        with span("monitor.ingest"):
            frame_dev = self._ingest(frame)
        if consume:
            new_state, sample, bpm_res = _measure_and_estimate(
                self._measure_state, frame_dev, spec, self._lowpass,
                max(self.peak_minimum_sample_distance, 1),
                self.config.measure)
        else:
            with span("monitor.motion"):
                new_state, sample = motion.measure_step(
                    self._measure_state, frame_dev, spec)
        self._measure_state = new_state
        located = None
        if self.config.streaming_roi and self._streaming_state is not None:
            located = self._streaming_roi_step(frame_dev)

        # One device-to-host copy for the frame; it waits for the device,
        # so the tag times execution.
        wanted = [sample, new_state.error]
        if flow:
            wanted += [new_state.pts, new_state.pts_valid]
        if consume:
            wanted += [bpm_res.filtered, bpm_res.accept_mask,
                       bpm_res.cand_idx, bpm_res.has_bpm, bpm_res.bpm]
        if located is not None:
            wanted += [located.found, located.x, located.y, located.w,
                       located.h]
        with span("monitor.host_read"):
            host = _to_host(*wanted)
        if located is not None:
            self._relock(frame_dev, *(int(v) for v in host[-5:]))
            host = host[:-5]
        with span("monitor.mirror"):
            sample_val = float(host[0])
            error = bool(host[1])

            self.data.append(sample_val)
            self.t.append(0.0 if len(self.t) == 0
                          else self.t[-1] + 1.0 / self.fps)

            # Host mirrors for the UI / API surface.  uint8 ingest converts the
            # host crop via the reference chain (base.py:230-233) so the
            # observable ``cropped_image`` stays float [0, 1] in either mode.
            crop_host = frame[self.y:self.y + self.h, self.x:self.x + self.w]
            self.cropped_image = (
                np.asarray(crop_host, np.float64) * (1.0 / 255.0)
                if self.ingest_uint8 else np.asarray(crop_host))
            if flow:
                pts, valid = host[2], host[3]
                self.motion_key_points = pts[valid].reshape(-1, 1, 2)

            if self.config.save_all_data:
                # uint8 ingest records the ORIGINAL camera bytes (strictly more
                # faithful than the float round-trip, which can lose 1 code on
                # bytes whose f->u8 trunc lands just below the integer).
                crop_u8 = np.asarray(crop_host) if self.ingest_uint8 else \
                    np.clip(np.trunc(self.cropped_image * 255.0),
                            0, 255).astype(np.uint8)
                self._recorder.write(crop_u8, self.t[-1], sample_val)
                self.all_data.append((self.t[-1], sample_val))

            # First-flow-frame "no keypoints" trigger fires immediately
            # (base.py:367-368), unlike NaN detection which waits for the
            # initialization length (base.py:489-494).
            if error and not math.isnan(sample_val) and len(self.data) == 1:
                self.trigger_error("No motion key points found.")
            elif len(self.data) > init_len:
                self._consume_bpm(*host[-5:])
                if not self.disable_error_detection and self.detect_errors():
                    self.trigger_error("error detection found poor signal")
        self.benchmarker.tick_end("Measurement Loop")

    def _streaming_roi_step(self, frame_dev):
        """Streaming-ROI mode: absorb the frame into the rings every frame
        (the bandpass needs a contiguous fps-rate window), and every
        ``streaming_interval`` frames localize over the window too.
        Returns the localize's result, or None."""
        self._streaming_tick += 1
        return self._streaming_absorb(
            frame_dev, "measure",
            localize=self._streaming_tick % self.config.streaming_interval
            == 0)

    def _relock(self, frame_dev, found, bx, by, bw, bh):
        """When the located center has drifted at least
        ``streaming_drift_px``, re-lock the measurement window onto it via
        ``motion.relock_state``: tracked points and the signal ring
        survive, so a moving subject is followed instead of decaying into
        the error-recalibrate stall.  The window KEEPS its calibrated size
        (recentred on the new bbox center, clipped to the frame): the crop
        bucket and the session recorder's geometry stay fixed."""
        if not found:
            return
        cx = bx + bw / 2.0
        cy = by + bh / 2.0
        drift = math.hypot(cx - (self.x + self.w / 2.0),
                           cy - (self.y + self.h / 2.0))
        if drift < self.config.streaming_drift_px:
            return
        x2 = int(round(cx - self.w / 2.0))
        y2 = int(round(cy - self.h / 2.0))
        x2 = max(0, min(x2, self.width - self.w))
        y2 = max(0, min(y2, self.height - self.h))
        if (x2, y2) == (self.x, self.y):
            return
        self._measure_state = motion.relock_state(
            self._measure_state, frame_dev, (x2, y2, self.w, self.h),
            self._measure_spec)
        self.x, self.y = x2, y2
        self.relocks += 1
        logger.info("Streaming re-lock #%d: ROI -> (%d, %d, %d, %d), "
                    "drift %.1f px", self.relocks, x2, y2, self.w, self.h,
                    drift)

    def _consume_bpm(self, filtered, accept_mask, cand_idx, has_bpm, bpm):
        """Host mirrors of the frame's BPM result (host copies of its
        fields; the device-side signal ring equals the host deque by
        construction)."""
        n = self.config.measure.buffer_length
        count = len(self.data)
        self.filtered_data = filtered[n - count:]
        idxs = cand_idx[accept_mask] - (n - count)
        self.peak_indices = [int(i) for i in idxs]
        self.peak_times = np.take(np.asarray(self.t), self.peak_indices) \
            if self.peak_indices else np.array([])
        if bool(has_bpm):
            self.freq.append(float(bpm))

    # ------------------------------------------------------------------
    # UI (reference base.py:255-297)
    # ------------------------------------------------------------------

    def update_ui(self):
        ui = self.ui
        if self.state == "calibration":
            if self.calibration_buffer_idx < \
                    self.calibration_buffer_target_length:
                ui.set_window_title(
                    "Capturing calibration frames... {0}/{1}".format(
                        self.calibration_buffer_idx,
                        self.calibration_buffer_target_length))
                # uint8 ingest: display in the float [0, 1] convention the
                # UI expects in every mode.
                self.display_frame = (
                    self.current_frame.astype(np.float64) * (1.0 / 255.0)
                    if self.ingest_uint8 else self.current_frame)
                ui.set_image(self.display_frame)
            else:
                ui.set_window_title("Measuring...")
        elif self.state == "measure":
            if self.cropped_image is None:
                ui.set_plot_autoscale(True)
                return
            # nan_to_num: a blacked-out/NaN frame (fault injection) must
            # still render (as black), not warn on the uint8 cast.
            self.display_frame = np.nan_to_num(np.clip(
                np.trunc(self.cropped_image * 255.0), 0, 255)) \
                .astype(np.uint8)
            if self.config.motion_extraction_method == "flow":
                # Flow keypoint overlay (reference base.py:272-277): white
                # circles mark the currently tracked points on the crop.
                self.display_frame = overlay_keypoints(
                    self.display_frame, self.motion_key_points)
                ui.set_keypoints(self.motion_key_points)
            dots = ".".join(["" for _ in
                             range(0, len(self.filtered_data) % 4)])
            if len(self.peak_times) > 0:
                ui.set_peaks(self.peak_times,
                             np.take(self.filtered_data, self.peak_indices))
            ui.set_window_title("Measuring." + dots)
            if len(self.filtered_data) >= 2 and len(self.t) >= 2:
                ui.set_plot_x_range(min(self.t), max(self.t))
                ui.set_raw_signal(list(self.t), list(self.filtered_data))
            ui.set_image(self.display_frame)
            if len(self.freq) >= 2 and len(self.t) >= 2:
                ui.set_frequency(
                    np.asarray(self.t)[-len(self.freq):], list(self.freq))
                ui.set_bpm_text("{0:#.4} BPM".format(self.freq[-1]))
        elif self.state == "error":
            ui.set_bpm_text("??? BPM")
            ui.set_window_title(
                "Error: Recalibrating due to poor signal in {0}s.".format(
                    self.config.error_reset_delay
                    - (time.time() - self.reset_start_time)))
        ui.process_events()

    def _save_calibration_image(self, result: evm.LocateResult):
        """Write the 2x3 montage PNG (reference base.py:577-596)."""
        try:
            import cv2
        except ImportError:  # pragma: no cover
            logger.warning("cv2 unavailable; skipping calibration image")
            return
        import os

        logger.info("Creating calibration image.")
        mean_frame = self.calibration_buffer.mean(axis=0)
        if not self.ingest_uint8:
            mean_frame = mean_frame * 255.0   # float buffers live in [0, 1]
        total_avg = np.clip(np.trunc(mean_frame), 0, 255).astype(np.uint8)
        heat = result.heatmap_u8.cpu().numpy()
        raw_heat = result.raw_heat_u8.cpu().numpy()
        thresh = result.thresh.cpu().numpy()

        contours_found = cv2.findContours(thresh.copy(), cv2.RETR_EXTERNAL,
                                          cv2.CHAIN_APPROX_SIMPLE)
        contours = contours_found[0] if len(contours_found) == 2 \
            else contours_found[1]
        contour_img = total_avg.copy()
        cv2.drawContours(contour_img, contours, -1, (0, 255, 0), 3)
        drawn = cv2.rectangle(total_avg + heat, (self.x, self.y),
                              (self.x + self.w, self.y + self.h), 255, 2)

        row0 = np.hstack((total_avg, raw_heat, heat))
        row1 = np.hstack((thresh, contour_img, drawn))
        montage = np.vstack((row0, row1))
        i = 0
        while os.path.exists("calibration%s.png" % i):
            i += 1
        cv2.imwrite("calibration%s.png" % i, montage)
        logger.info("Calibration image saved.")
