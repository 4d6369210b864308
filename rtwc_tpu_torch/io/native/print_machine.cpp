// Native print machine: double-buffered background console blitter.
//
// The TPU-native framework keeps its runtime native where the reference's
// is: PrintMachine (PrintMachine.h/.cpp) is C++ host code running a
// dedicated detached print thread that swaps a mutex-guarded double buffer
// and fwrite()s whole frames to the console at its own rate, decoupled
// from rendering (PrintMachine.cpp:150-151,257-306). This is that thread,
// as a small C++ object driven from Python over ctypes: the producer
// (engine) publishes encoded ANSI frames; the consumer thread writes
// cursor-home + frame + FPS overlay to the output fd. Running the blit
// outside the GIL lets the Python render loop keep dispatching device work
// while a large frame drains to the terminal.
//
// Contract mirrors io/presenter.py's Python print loop byte-for-byte:
//   ESC[H + frame + (optional) "\x1b[0mRendering FPS: %8.1f\nPrinting  FPS: %8.1f"
// with 1 Hz printing-FPS accounting (PrintMachine.cpp:261-272) and an
// optional minimum period between blits (max print FPS cap).
//
// Build: g++ -O3 -shared -fPIC -pthread (see native/__init__.py).

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <unistd.h>

namespace {

using Clock = std::chrono::steady_clock;

struct Printer {
  int fd = 1;
  bool show_fps = true;
  double min_period = 0.0;  // seconds; 0 = uncapped

  std::mutex mu;
  std::condition_variable cv;
  std::vector<uint8_t> back;    // producer-filled (guarded by mu)
  bool fresh = false;
  std::atomic<bool> terminate{false};
  std::atomic<bool> running{false};

  std::atomic<double> rendering_fps{0.0};
  std::atomic<double> printing_fps{0.0};

  std::thread thread;

  void loop() {
    std::vector<uint8_t> current;
    std::vector<uint8_t> frame;  // assembled output (reused allocation)
    std::string last_overlay = "\x01";  // sentinel: first frame always blits
    int print_count = 0;
    auto fps_t0 = Clock::now();
    bool write_dead = false;
    while (true) {
      // Loop unconditionally and check `fresh` under the lock BEFORE the
      // terminate test (same ordering as the Python _print_loop): a frame
      // published while the thread was mid-blit or between iterations
      // still gets one blit after stop() (drain-on-stop - a short --frames
      // run must not exit with zero output). Break only when terminate is
      // set and nothing fresh is pending.
      bool got_fresh = false;
      {
        std::unique_lock<std::mutex> lk(mu);
        // Wake on a fresh frame or termination (2 ms poll tick).
        cv.wait_for(lk, std::chrono::milliseconds(2),
                    [&] { return fresh || terminate.load(); });
        if (fresh) {
          current.swap(back);
          fresh = false;
          got_fresh = true;
        }
        if (!got_fresh && terminate.load(std::memory_order_relaxed)) break;
      }
      if (write_dead) break;  // fd is gone; draining would just fail again
      if (current.empty()) {
        if (terminate.load(std::memory_order_relaxed)) break;
        continue;
      }

      char overlay[96];
      int overlay_n = 0;
      if (show_fps) {
        overlay_n = std::snprintf(overlay, sizeof(overlay),
                                  "\x1b[0mRendering FPS: %8.1f\nPrinting  FPS: %8.1f",
                                  rendering_fps.load(), printing_fps.load());
        if (overlay_n < 0) overlay_n = 0;
      }
      // Gate the re-blit: when nothing is fresh and the overlay text is
      // unchanged, writing the identical bytes again at ~500 Hz is pure
      // wasted terminal bandwidth (the reference does exactly that,
      // PrintMachine.cpp:257-306 - deliberately not kept). The held frame
      // re-blits only when the 1 Hz FPS text changes.
      if (!got_fresh &&
          last_overlay.compare(0, std::string::npos, overlay,
                               static_cast<size_t>(overlay_n)) == 0) {
        continue;
      }

      auto t_start = Clock::now();
      frame.clear();
      static const char kHome[] = "\x1b[H";
      frame.insert(frame.end(), kHome, kHome + 3);
      frame.insert(frame.end(), current.begin(), current.end());
      if (overlay_n > 0) frame.insert(frame.end(), overlay, overlay + overlay_n);
      last_overlay.assign(overlay, static_cast<size_t>(overlay_n));
      // Whole-frame write (PrintMachine.cpp:290 fwrite); loop over partial
      // writes - terminals can short-write under load.
      const uint8_t* p = frame.data();
      size_t left = frame.size();
      while (left > 0) {
        ssize_t w = ::write(fd, p, left);
        if (w <= 0) {
          if (errno == EINTR) continue;
          terminate.store(true);  // broken pipe etc: stop like the
          write_dead = true;      // reference's dead print thread
          break;
        }
        p += w;
        left -= static_cast<size_t>(w);
      }
      ++print_count;

      auto now = Clock::now();
      double since = std::chrono::duration<double>(now - fps_t0).count();
      if (since >= 1.0) {  // 1 Hz (PrintMachine.cpp:266-272)
        printing_fps.store(print_count / since);
        print_count = 0;
        fps_t0 = now;
      }
      if (min_period > 0.0) {
        double took = std::chrono::duration<double>(Clock::now() - t_start).count();
        if (took < min_period) {
          std::this_thread::sleep_for(
              std::chrono::duration<double>(min_period - took));
        }
      }
    }
    running.store(false);
  }
};

}  // namespace

extern "C" {

void* rtwc_printer_start(int fd, int show_fps, double min_period) {
  auto* pr = new Printer();
  pr->fd = fd;
  pr->show_fps = show_fps != 0;
  pr->min_period = min_period;
  pr->running.store(true);
  pr->thread = std::thread([pr] { pr->loop(); });
  return pr;
}

// Producer side (PrintMachine::SetDataInBackBuffer, PrintMachine.cpp:178-192).
void rtwc_printer_publish(void* h, const uint8_t* data, int64_t n) {
  auto* pr = static_cast<Printer*>(h);
  {
    std::lock_guard<std::mutex> lk(pr->mu);
    pr->back.assign(data, data + n);
    pr->fresh = true;
  }
  pr->cv.notify_one();
}

void rtwc_printer_set_rendering_fps(void* h, double fps) {
  static_cast<Printer*>(h)->rendering_fps.store(fps);
}

double rtwc_printer_printing_fps(void* h) {
  return static_cast<Printer*>(h)->printing_fps.load();
}

int rtwc_printer_running(void* h) {
  auto* pr = static_cast<Printer*>(h);
  return (pr->running.load() && !pr->terminate.load()) ? 1 : 0;
}

void rtwc_printer_stop(void* h) {
  auto* pr = static_cast<Printer*>(h);
  pr->terminate.store(true);
  pr->cv.notify_one();
  if (pr->thread.joinable()) pr->thread.join();
  delete pr;
}

}  // extern "C"
