// Asynchronous sequential file writer — out-of-core history spilling.
//
// The reference's IO is a synchronous CSV dump at exit (io.cpp:7-43,
// /root/reference/src/io.cpp); at N=1M scale the particle history
// (T x N x d, e.g. 8 GB at N=1M, T=1000, d=2) can exceed host RAM and a
// blocking write() per chunk would stall the device between scan chunks.
// This writer copies each submitted chunk into an owned buffer from a
// bounded pool and appends it to the target file on a background thread,
// so the Python streaming loop returns to dispatching the next device
// chunk immediately.
//
// C ABI (ctypes, see cusmc_tpu/io/disk_store.py):
//   h = csmc_writer_create(path, queue_depth)   -> handle (0 on fail)
//   csmc_writer_submit(h, data, nbytes)         -> 0 ok (blocks only when
//                                                  queue_depth chunks are
//                                                  already in flight)
//   csmc_writer_flush(h)                        -> 0 ok; drains + fsyncs
//   csmc_writer_error(h)                        -> sticky errno (0 = none)
//   csmc_writer_destroy(h)                      -> drains, closes, frees

#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <new>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

namespace {

struct Chunk {
  std::vector<char> data;
};

struct Writer {
  int fd = -1;
  size_t max_queue = 4;
  std::deque<Chunk> queue;
  std::mutex mu;
  std::condition_variable cv_push;  // signals space in the queue
  std::condition_variable cv_work;  // signals work / shutdown
  std::thread worker;
  bool stop = false;
  int error = 0;  // sticky errno

  void run() {
    for (;;) {
      Chunk c;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] { return stop || !queue.empty(); });
        if (queue.empty()) {
          if (stop) return;
          continue;
        }
        c = std::move(queue.front());
        queue.pop_front();
      }
      const char* p = c.data.data();
      size_t left = c.data.size();
      while (left > 0 && error == 0) {
        ssize_t n = ::write(fd, p, left);
        if (n < 0) {
          if (errno == EINTR) continue;
          std::lock_guard<std::mutex> lk(mu);
          error = errno ? errno : EIO;
          break;
        }
        p += n;
        left -= static_cast<size_t>(n);
      }
      cv_push.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* csmc_writer_create(const char* path, int64_t queue_depth) {
  if (!path || queue_depth <= 0) return nullptr;
  int fd = ::open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return nullptr;
  Writer* w = new (std::nothrow) Writer;
  if (!w) {
    ::close(fd);
    return nullptr;
  }
  w->fd = fd;
  w->max_queue = static_cast<size_t>(queue_depth);
  w->worker = std::thread([w] { w->run(); });
  return w;
}

int csmc_writer_submit(void* h, const void* data, int64_t nbytes) {
  Writer* w = static_cast<Writer*>(h);
  if (!w || !data || nbytes < 0) return EINVAL;
  Chunk c;
  c.data.resize(static_cast<size_t>(nbytes));
  std::memcpy(c.data.data(), data, static_cast<size_t>(nbytes));
  std::unique_lock<std::mutex> lk(w->mu);
  w->cv_push.wait(lk, [&] { return w->queue.size() < w->max_queue
                                   || w->error != 0; });
  if (w->error != 0) return w->error;
  w->queue.push_back(std::move(c));
  w->cv_work.notify_one();
  return 0;
}

int csmc_writer_flush(void* h) {
  Writer* w = static_cast<Writer*>(h);
  if (!w) return EINVAL;
  {
    std::unique_lock<std::mutex> lk(w->mu);
    w->cv_push.wait(lk, [&] { return w->queue.empty() || w->error != 0; });
    if (w->error != 0) return w->error;
  }
  if (::fsync(w->fd) != 0) {
    std::lock_guard<std::mutex> lk(w->mu);
    w->error = errno ? errno : EIO;
  }
  return w->error;
}

int csmc_writer_error(void* h) {
  Writer* w = static_cast<Writer*>(h);
  if (!w) return EINVAL;
  std::lock_guard<std::mutex> lk(w->mu);
  return w->error;
}

void csmc_writer_destroy(void* h) {
  Writer* w = static_cast<Writer*>(h);
  if (!w) return;
  {
    std::lock_guard<std::mutex> lk(w->mu);
    w->stop = true;
  }
  w->cv_work.notify_all();
  w->worker.join();
  ::close(w->fd);
  delete w;
}

}  // extern "C"
