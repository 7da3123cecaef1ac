"""Background frame staging — overlap host input IO with device compute.

The reference overlaps input with compute through ROS callback queues filled
by the transport thread (main.cpp:537-858, qImg/qCloudPixel) while the
pipeline thread consumes them. The TPU-native equivalent stages the next
frame's (image, cloud) on a host thread while the device processes the
current frame:

  * velodyne clouds come from the native C++ prefetcher
    (native/staging.cpp:105-179, sdv_prefetcher_*) when the reader exposes
    `velodyne_files` and the shared library is built — a real worker thread
    outside the GIL;
  * images go through the reader's own `get_image` (PNG decode through
    io/images.py + photometric + undistort remap) on the staging thread —
    zlib and numpy release the GIL for the heavy parts.

Because `FullSystem.add_active_frame` waits on the device with the GIL
released, the staging thread fills that window.
"""

from __future__ import annotations

import queue
import threading


class PrefetchReader:
    """Wrap a sequence reader; `get(i)` returns frames staged ahead.

    Frames must be consumed in order (the odometry main loop is strictly
    sequential, runner.run_sequence); out-of-order access falls back to the
    wrapped reader.
    """

    def __init__(self, reader, depth: int = 2, max_points: int = 200000):
        self.reader = reader
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stash = None  # consumer-side holdback for backward skips
        self._stop = threading.Event()
        self._native_pf = None
        vels = getattr(reader, "velodyne_files", None)
        if vels:
            from sdv_loam_tpu_torch.data import native
            if native.available():
                self._native_pf = native.CloudPrefetcher(
                    list(vels), max_points=max_points, depth=depth)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # passthrough metadata (calib, sensor, undistorter, timestamps, ...)
    def __getattr__(self, name):
        return getattr(self.reader, name)

    def __len__(self):
        return len(self.reader)

    def _stage(self, i: int):
        if self._native_pf is not None:
            img = self.reader.get_image(i)
            nxt = self._native_pf.next()
            if nxt is not None and nxt[0] == i:
                cloud = nxt[1]
            else:  # prefetcher out of phase (shouldn't happen): direct read
                cloud = self.reader.get_cloud(i)
            ts = float(self.reader.timestamps[i]) if hasattr(
                self.reader, "timestamps") else float(i) * 0.1
            return img, cloud, ts
        return self.reader.get(i)

    def _worker(self):
        try:
            for i in range(len(self.reader)):
                if self._stop.is_set():
                    return
                self._q.put((i, self._stage(i)))
        except Exception as e:  # surface IO errors at the consumer
            self._q.put((-1, e))

    def get(self, i: int):
        """(image, cloud, timestamp) for frame i (sequential fast path)."""
        while True:
            if self._stash is not None:
                j, item = self._stash
                self._stash = None
            else:
                j, item = self._q.get()
            if j == -1:
                raise item if isinstance(item, Exception) else RuntimeError(
                    str(item))
            if j == i:
                return item
            if j > i:  # consumer skipped backward: direct read, keep staged
                # hold the staged frame locally — pushing back into the
                # Queue's deque would race the worker's put() (unlocked
                # mutation + broken not_empty/unfinished accounting)
                self._stash = (j, item)
                return self.reader.get(i)
            # j < i: consumer skipped forward; drop stale staged frames

    def close(self):
        self._stop.set()
        try:  # drain so the worker's blocked put() can exit
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._native_pf is not None:
            self._native_pf.close()
            self._native_pf = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
